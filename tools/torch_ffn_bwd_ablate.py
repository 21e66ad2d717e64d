"""Where the FF backward's up stage spends its time, by ablation.

Builds variants of `cat_tpu_torch/csrc/ffn_bwd.cu`, each with one part of
the up stage (`ffn_bwd_up`) taken out or changed: the Philox keep bits
(every value kept), the stores of a1 and dh1, the sigmoid (a constant), all
three of its epilogue's parts, or 2 or 3 pipeline stages instead of 4. It
times every launch of one call of each variant at chip_smoke.py's training
batch (R = 15,776, D = 512, F = 2048), device time by kernel name from
torch.profiler over 10 calls, at dropout 0.1 and 0. The variants compute
wrong gradients: they are for timing only and never leave this script.
Needs a card:

    python3 tools/torch_ffn_bwd_ablate.py

prints the card's name and power limit, then one line per variant and rate.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

R, D, F = 32 * 493, 512, 2048
KEEP = "const unsigned mine = keep4(dr, 0, 0, row0 + 8 * odd, c >> 2);"
STORE = "            if (row < R && cv) {"
SIGMOID = "const float sg = __fdividef(1.f, 1.f + __expf(-v));"
STAGES = "constexpr int UP_STAGES = 4,"
VARIANTS = {
    "base": [],
    "no_philox": [(KEEP, "const unsigned mine = 0xFu;")],
    "no_store": [(STORE, "            if (row < 0) {")],
    "no_sigmoid": [(SIGMOID, "const float sg = 0.5f;")],
    "no_epilogue": [(KEEP, "const unsigned mine = 0xFu;"),
                    (STORE, "            if (row < 0) {"),
                    (SIGMOID, "const float sg = 0.5f;")],
    "stages_2": [(STAGES, "constexpr int UP_STAGES = 2,")],
    "stages_3": [(STAGES, "constexpr int UP_STAGES = 3,")],
}


def build(out_dir):
    from cat_tpu_torch import _build
    csrc = os.path.join(REPO, "cat_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "ffn_bwd.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in ffn_bwd.cu")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"ffn_bwd_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libffn_bwd_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
        cdll = ctypes.CDLL(lib)
        cdll.ffn_bwd.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
                                 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        cdll.ffn_bwd_workspace.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        libs[name] = cdll
    return libs


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    ins = (rnd(R, D, dtype=bf), 1 + rnd(D, s=0.1), rnd(D, s=0.1),
           rnd(D, F, s=D ** -0.5, dtype=bf), rnd(F, s=0.1),
           rnd(F, D, s=F ** -0.5, dtype=bf), rnd(R, D, dtype=bf))
    outs = [torch.empty(*s, dtype=t, device="cuda") for s, t in (
        ((R, D), bf), ((R, D), bf), ((R, D), bf), ((R, F), bf), ((R, F), bf),
        ((D,), f32), ((D,), f32), ((D, F), f32), ((F,), f32), ((F, D), f32),
        ((D,), f32))]
    stream = torch.cuda.current_stream().cuda_stream
    for rate in (0.1, 0.0):
        drop, inv = kernel_args(rate, (0x0BADF00D, 0x5EED1234))
        for name, lib in libs.items():
            units = lib.ffn_bwd_workspace(R, D, F, None)
            ws = torch.empty(units * 64, dtype=f32, device="cuda")
            ptrs = [t.data_ptr() for t in (*ins, *outs, ws)]

            def call():
                err = lib.ffn_bwd(*ptrs, R, D, F, *drop, units, 0.5, inv,
                                  stream)
                if err:
                    raise SystemExit(f"{name}: CUDA error {err}")

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            ms = {}
            for e in prof.events():
                m = re.search(r"ffn_bwd_(\w+)", e.name)
                if e.device_type.name == "CUDA" and m:
                    ms[m.group(1)] = ms.get(m.group(1), 0.0) + (
                        e.time_range.end - e.time_range.start) / 10 / 1e3
            print(f"rate {rate} {name:12s} " + " ".join(
                f"{k} {v:.4f}" for k, v in ms.items())
                + f" sum {sum(ms.values()):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
