"""Time the dense-den kernels of several checkouts of this repo on one card,
or variants of this checkout's `csrc/crf_dense.cu` by ablation.

`cat_tpu_torch.ops.crf_dense.den_forward` (PERF.md §6 row 22) and
`den_backward` at chip_smoke.py's crf-v1 training batch (N = 32, T' =
299..493, 12,664 valid frames, V = 72, its 3-gram denominator), CUDA
events over 10 calls after 2 warm-up calls.

    python3 tools/torch_den_ab.py PARENT_CHECKOUT .

runs each checkout in its own process (which builds that checkout's
kernels into its own `build/kernels/`), in the order given and then in
reverse (A, B, B, A for two), so that drift of the card's clocks shows as
a spread and not as a difference.

    python3 tools/torch_den_ab.py --ablate

builds variants of this checkout's `crf_dense.cu` (all at once) and times
both kernels of each: as built; tiles of 8 outputs over 8 lanes (NT =
KP = 8) instead of 4; the forward contraction's loop unrolled 4 times
instead of 2; the contractions taken out (their sums stay 0);
and every forward frame cut to its cluster barrier alone, whose time over
the 493 frames is the cost of one barrier with the loop around it.
Variants that take a part out compute wrong outputs: they are for timing
only and never leave this script.

Prints the card's name and power limit, one line per run and, last, one
JSON object {"device": ..., "runs": [{"tree" or "variant": ..., "case":
..., "ms": ...}, ...]}. Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

TRAIN_FRAMES = [1200 + 25 * k for k in range(32)]
CONTRACT = "fma_tile<G>(acc, pp + a * pstride, w);"
BETA = "fma_tile<G>(acc, pp + u * PG, w);"
FRAME = "  const float yv = load_y<G>(k, P, t_next, slot);\n  // rows b"
NT = "constexpr int NT = 4;"
UNROLL = "#pragma unroll 2\n      for (int a = h; a < V; a += KP) {"
VARIANTS = {"as built": [],
            "NT = KP = 8": [(NT, "constexpr int NT = 8;")],
            "unroll 4": [(UNROLL, UNROLL.replace("unroll 2", "unroll 4"))],
            "no contraction": [(CONTRACT, ";"), (BETA, ";")],
            "barrier only": [(FRAME, FRAME.replace(
                "\n  // rows b", "\n  cg::this_cluster().sync();\n"
                "  if (k.V > 0) return;\n  // rows b"))]}


def inputs(torch):
    """The training batch's log-probs and lengths, and the denominator."""
    import chip_smoke
    tl = [chip_smoke.subsampled(f) for f in TRAIN_FRAMES]
    gen = torch.Generator(device="cuda").manual_seed(4)
    lp = torch.log_softmax(
        torch.randn(len(tl), max(tl), 72, generator=gen, device="cuda") * 2,
        -1).contiguous()
    g = 1 + 0.5 * torch.randn(len(tl), generator=gen, device="cuda").abs()
    return lp, torch.tensor(tl, device="cuda"), chip_smoke.make_den(), g


def timed(torch, fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def child(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from cat_tpu_torch.ops import crf_dense
    if not os.path.abspath(crf_dense.__file__).startswith(
            os.path.abspath(tree)):
        raise SystemExit(f"imported {crf_dense.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    lp, lens, den, g = inputs(torch)
    snaps, logz = crf_dense.den_forward(lp, lens, den)
    print(json.dumps({
        "den_forward": timed(torch, lambda: crf_dense.den_forward(
            lp, lens, den)),
        "den_backward": timed(torch, lambda: crf_dense.den_backward(
            lp, lens, snaps, logz, g, den))}))


def ablate() -> list:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import torch
    from cat_tpu_torch import _build
    from cat_tpu_torch.ops import crf_dense
    import chip_smoke
    lp, lens, den, g = inputs(torch)
    for bwd in (False, True):
        plan = crf_dense.den_plan(
            lens, 72, crf_dense._cluster_count(den, lens.device, bwd), bwd)
        print(f"{'den_backward' if bwd else 'den_forward'} plan: {plan}",
              flush=True)
    src = (_build.CSRC / "crf_dense.cu").read_text()
    out_dir = os.path.join(repo, "build", "den_ablate")
    os.makedirs(out_dir, exist_ok=True)
    runs, builds = [], {}
    for name, subs in VARIANTS.items():   # all variants' nvcc at once
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        stem = "".join(ch if ch.isalnum() else "_" for ch in name)
        cu = os.path.join(out_dir, f"{stem}.cu")
        lib = os.path.join(out_dir, f"lib{stem}.so")
        with open(cu, "w") as f:
            f.write(text)
        builds[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", lib, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for name, (lib, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if re.search(r"[1-9][0-9]* bytes spill", ln)})
        if spills:
            print(f"{name}: {spills}", flush=True)
        cdll = ctypes.CDLL(lib)
        for fn_name, (n_ptr, n_int, n_float) in crf_dense._ENTRIES.items():
            fn = getattr(cdll, fn_name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_float] * n_float + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _build._libs["crf_dense"] = cdll
        den = chip_smoke.make_den()  # no cluster count of another variant
        snaps, logz = crf_dense.den_forward(lp, lens, den)
        frames = int(lens.max())
        for case, call in (
                ("den_forward", lambda: crf_dense.den_forward(lp, lens, den)),
                ("den_backward", lambda: crf_dense.den_backward(
                    lp, lens, snaps, logz, g, den))):
            ms = timed(torch, call)
            runs.append({"variant": name, "case": case, "ms": ms})
            print(f"{case} {name}: {ms:.4f} ms ({1e3 * ms / frames:.3f} us a "
                  f"frame over {frames} frames)", flush=True)
    return runs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", help="checkouts of this repo")
    ap.add_argument("--ablate", action="store_true",
                    help="time variants of this checkout's crf_dense.cu")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.trees[0])
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.ablate:
        print(json.dumps({"device": smi, "runs": ablate()}))
        return
    runs = []
    for tree in args.trees + args.trees[::-1]:
        tree = os.path.abspath(tree)
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", tree], capture_output=True,
                             text=True, cwd=tree)
        if out.returncode != 0:
            raise SystemExit(f"{tree}: exit {out.returncode}\n"
                             f"{out.stderr[-4000:]}")
        for case, ms in json.loads(out.stdout.strip().splitlines()[-1]).items():
            runs.append({"tree": tree, "case": case, "ms": ms})
            print(f"{case} {tree}: {ms:.4f} ms (N=32, T'=299..493, V=72)",
                  flush=True)
    print(json.dumps({"device": smi, "runs": runs}))


if __name__ == "__main__":
    main()
