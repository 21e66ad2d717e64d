"""Where the conv module's bn_out kernels spend their time, by ablation.

Builds variants of `cat_tpu_torch/csrc/bn_out.cu`, each with one part
changed, and times every launch of one call of each direction of each
variant, device time by kernel name from torch.profiler over 10 calls, at
chip_smoke.py's training batch (R = 15,776, D = 512) and serving batch
(R = 4,792) at dropout 0.1:
- base: the source as it is;
- prep_warps_8: the backward's prep pass with 8 warps to a 64-row block
  (8 rows a warp) instead of 16;
- fwd_coop: the forward's product on 128-row cooperative tiles instead
  of 64-row ping-pong ones;
- fwd_stages_6: 6 pipeline stages in the forward's product (8 on
  its ping-pong tiles, 6 on cooperative ones) instead of 4; down_stages_3, down_stages_8: 3 or 8 in
  the backward's down product instead of 4;
- no_philox: every value kept, without Philox, in all four passes that
  draw the mask (timing only).
Variants compute the same outputs except no_philox; none of them leaves
this script. Needs a card:

    python3 tools/torch_bn_out_ablate.py

prints the card's name and power limit, then one line per variant, batch
and direction.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

D = 512
ROWS = {"train": 32 * 493, "serve": 8 * 599}
SCHEDULE = "return launch_fwd_product<true>("
VARIANTS = {
    "base": [],
    "prep_warps_8": [("PREP_WARPS = 16;", "PREP_WARPS = 8;")],
    "fwd_coop": [(SCHEDULE, "return launch_fwd_product<false>(")],
    "fwd_stages_6": [("FWD_STAGES = 4, FWD_STAGES_PP = 4",
                      "FWD_STAGES = 6, FWD_STAGES_PP = 8")],
    "down_stages_3": [("DOWN_STAGES = 4,", "DOWN_STAGES = 3,")],
    "down_stages_8": [("DOWN_STAGES = 4,", "DOWN_STAGES = 8,")],
    "no_philox": [("a.dr = Drop{(uint32_t)seed0, (uint32_t)seed1, "
                   "(uint32_t)thr, inv};",
                   "a.dr = Drop{0u, 0u, 0u, inv};")],
}
SPECS = {"bn_out_fwd": (11, 5, 1), "bn_out_bwd": (18, 8, 1)}


def build(out_dir):
    from cat_tpu_torch import _build
    csrc = os.path.join(REPO, "cat_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "bn_out.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in bn_out.cu")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"bn_out_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libbn_out_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
        cdll = ctypes.CDLL(lib)
        for entry, (n_ptr, n_int, n_float) in SPECS.items():
            getattr(cdll, entry).argtypes = (
                [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        libs[name] = cdll
    return libs


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cat_tpu_torch.ops.conv_module import bn_out_plan
    from cat_tpu_torch.ops.dropout import kernel_args
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build(os.path.join(REPO, "build", "ablate"))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * s).to(dtype)

    bf, f32 = torch.bfloat16, torch.float32
    new = lambda *s, dt=bf: torch.empty(*s, dtype=dt, device="cuda")  # noqa
    stream = torch.cuda.current_stream().cuda_stream
    drop, inv = kernel_args(0.1, (0x0BADF00D, 0x5EED1234))
    vecs = (rnd(D, s=0.1), 1 + rnd(D, s=0.2).abs(), 1 + rnd(D, s=0.1),
            rnd(D, s=0.1))
    w, bw = rnd(D, D, s=D ** -0.5, dtype=bf), rnd(D, s=0.1)
    for batch, R in ROWS.items():
        conv, x, do = (rnd(R, D, dtype=bf) for _ in range(3))
        mask = (torch.rand(R, generator=gen, device="cuda") > 0.2).float()
        plan = bn_out_plan(R, D)
        grads = [new(R, D), new(R, D), new(R, D), *(new(D, dt=f32)
                                                     for _ in range(4)),
                 new(D, D, dt=f32), new(D, dt=f32),
                 new(plan.ws_floats, dt=f32)]
        calls = {
            "bn_out_fwd": (*(t.data_ptr() for t in (
                conv, x, mask, *vecs, w, bw, new(R, D), new(R, D))),
                R, D, *drop, inv, stream),
            "bn_out_bwd": (*(t.data_ptr() for t in (
                conv, mask, *vecs, w, do, *grads)),
                R, D, plan.splits, plan.per, plan.ws_floats // 64, *drop,
                inv, stream)}
        for name, lib in libs.items():
            for entry, args in calls.items():
                fn = getattr(lib, entry)

                def call():
                    err = fn(*args)
                    if err:
                        raise SystemExit(f"{name} {entry}: CUDA error {err}")

                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        call()
                    torch.cuda.synchronize()
                ms = {}
                for e in prof.events():
                    m = re.search(entry + r"_(\w+)", e.name)
                    if e.device_type.name == "CUDA" and m:
                        ms[m.group(1)] = ms.get(m.group(1), 0.0) + (
                            e.time_range.end - e.time_range.start) / 10 / 1e3
                print(f"{batch} R {R} {entry} {name:14s} " + " ".join(
                    f"{k} {v:.4f}" for k, v in ms.items())
                    + f" sum {sum(ms.values()):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
