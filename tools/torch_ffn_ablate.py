"""Where the FF module's kernels spend their time, by ablation.

Builds variants of `cat_tpu_torch/csrc/ffn_fwd.cu` or `ffn_bwd.cu`, each
with one part taken out or changed, and times every launch of one call of
each variant, device time by kernel name from torch.profiler over 10
calls, at chip_smoke.py's training batch (R = 15,776, D = 512, F = 2048)
at dropout 0.1 and 0, and for the forward also at its serving batch (R =
4,792) at dropout 0.
- fwd: the up stage's a1 store, the Philox keep bits of both products'
  epilogues (every value kept), both of them, 4 pipeline stages in each
  product instead of 5, the up stage on 64-row ping-pong tiles (6
  stages), the down stage with 6 stages, and the down stage on 64-row
  ping-pong or on 128-row cooperative tiles whatever R is;
- bwd: the up stage's (`ffn_bwd_up`) Philox keep bits, its stores of a1
  and dh1, its sigmoid (a constant), all three of them, or 2 or 3
  pipeline stages instead of 4.
Variants that take a part out compute wrong outputs: they are for timing
only and never leave this script. Needs a card:

    python3 tools/torch_ffn_ablate.py fwd|bwd

prints the card's name and power limit, then one line per variant, batch
and rate.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

D, F = 512, 2048
TRAIN, SERVE = 32 * 493, 8 * 599
KEEP = "const unsigned mine = keep4(dr, 0, 0, row0 + 8 * odd, c >> 2);"
# the forward's epilogues draw their keep bits with hg::keep_tile; a
# threshold of 0 keeps every value without Philox
FWD_KEEP = "hg::keep_tile(dr, "
FWD_NO_KEEP = "hg::keep_tile(Drop{0u, 0u, 0u, 1.f}, "
NO_KEEP = "const unsigned mine = 0xFu;"
SIGMOID = "const float sg = __fdividef(1.f, 1.f + __expf(-v));"
FWD_STORE = "          if (row < R && c < F)"
NO_STORE = "          if (row < 0)"
STORE = "            if (row < R && cv) {"
SCHEDULE = "return hg::pingpong(R, D / hg::BN)"
UP = "launch_up<false>("
# (source, entry, (pointers, ints, floats), variants, (rows, rate) cases)
KERNELS = {
    "fwd": ("ffn_fwd", (10, 6, 2), {
        "base": [],
        "no_a1_store": [(FWD_STORE, NO_STORE)],
        "no_philox": [(FWD_KEEP, FWD_NO_KEEP)],
        "no_store_no_philox": [(FWD_STORE, NO_STORE),
                               (FWD_KEEP, FWD_NO_KEEP)],
        "stages_4": [("UP_STAGES = 5, DOWN_STAGES = 5",
                      "UP_STAGES = 4, DOWN_STAGES = 4")],
        "down_pp": [(SCHEDULE, "return true")],
        "down_coop": [(SCHEDULE, "return false")],
        "up_pp": [(UP, "launch_up<true>("),
                  ("UP_STAGES = 5", "UP_STAGES = 6")],
        "down_stages_6": [("DOWN_STAGES = 5", "DOWN_STAGES = 6")],
    }, ((TRAIN, 0.1), (TRAIN, 0.0), (SERVE, 0.0))),
    "bwd": ("ffn_bwd", (19, 7, 2), {
        "base": [],
        "no_philox": [(KEEP, NO_KEEP)],
        "no_store": [(STORE, "            if (row < 0) {")],
        "no_sigmoid": [(SIGMOID, "const float sg = 0.5f;")],
        "no_epilogue": [(KEEP, NO_KEEP),
                        (STORE, "            if (row < 0) {"),
                        (SIGMOID, "const float sg = 0.5f;")],
        "stages_2": [("constexpr int UP_STAGES = 4,",
                      "constexpr int UP_STAGES = 2,")],
        "stages_3": [("constexpr int UP_STAGES = 4,",
                      "constexpr int UP_STAGES = 3,")],
    }, ((TRAIN, 0.1), (TRAIN, 0.0))),
}


def build(which, out_dir):
    from cat_tpu_torch import _build
    source, spec, variants, _ = KERNELS[which]
    csrc = os.path.join(REPO, "cat_tpu_torch", "csrc")
    src = open(os.path.join(csrc, f"{source}.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in {source}.cu")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{source}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{source}_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
        cdll = ctypes.CDLL(lib)
        n_ptr, n_int, n_float = spec
        getattr(cdll, source).argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
            + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        if which == "bwd":
            cdll.ffn_bwd_workspace.argtypes = [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
        libs[name] = cdll
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("which", choices=sorted(KERNELS))
    which = ap.parse_args().which
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cat_tpu_torch.ops.dropout import kernel_args
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    source, _, _, cases = KERNELS[which]
    libs = build(which, os.path.join(REPO, "build", "ablate"))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * s).to(dtype)

    bf, f32 = torch.bfloat16, torch.float32
    R = TRAIN
    x = rnd(R, D, dtype=bf)
    w = (1 + rnd(D, s=0.1), rnd(D, s=0.1), rnd(D, F, s=D ** -0.5, dtype=bf),
         rnd(F, s=0.1), rnd(F, D, s=F ** -0.5, dtype=bf))
    do = rnd(R, D, dtype=bf)
    b2 = rnd(D, s=0.1)
    new = lambda *s, dt=bf: torch.empty(*s, dtype=dt, device="cuda")  # noqa
    stream = torch.cuda.current_stream().cuda_stream
    for rows, rate in cases:
        drop, inv = kernel_args(rate, (0x0BADF00D, 0x5EED1234))
        for name, lib in libs.items():
            if which == "fwd":
                ptrs = [t.data_ptr() for t in (
                    x, *w, b2, new(rows, D), new(rows, D), new(rows, F))]
                args = (*ptrs, rows, D, F, *drop, 0.5, inv, stream)
            else:
                units = lib.ffn_bwd_workspace(rows, D, F, None)
                outs = [new(rows, D), new(rows, D), new(rows, D),
                        new(rows, F), new(rows, F), new(D, dt=f32),
                        new(D, dt=f32), new(D, F, dt=f32), new(F, dt=f32),
                        new(F, D, dt=f32), new(D, dt=f32),
                        new(units * 64, dt=f32)]
                ptrs = [t.data_ptr() for t in (x, *w, do, *outs)]
                args = (*ptrs, rows, D, F, *drop, units, 0.5, inv, stream)
            fn = getattr(lib, source)

            def call():
                err = fn(*args)
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
                m = re.search(source + r"_(\w+)", e.name)
                if e.device_type.name == "CUDA" and m:
                    ms[m.group(1)] = ms.get(m.group(1), 0.0) + (
                        e.time_range.end - e.time_range.start) / 10 / 1e3
            print(f"R {rows} rate {rate} {name:18s} " + " ".join(
                f"{k} {v:.4f}" for k, v in ms.items())
                + f" sum {sum(ms.values()):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
