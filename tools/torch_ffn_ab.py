"""Time the FF module's kernels of several checkouts of this repo on one card.

bfloat16 (the default): `cat_tpu_torch.ops.ffn.ff_backward` (PERF.md §6
row 13) and `ff_forward` (row 12) at chip_smoke.py's crf-v1 training
batch (R = 32 x 493 = 15,776 rows, D = 512, F = 2048, dropout 0.1), and
`ff_forward` at its serving batch (R = 8 x 599 = 4,792 rows, dropout 0).
`--dtype float32`: `ff_backward` on float32 tensors (row 13 f32,
`ff_backward_f32`) at crf-v1's width (the same R, D, F) and at llm-p2g
danp's first batch (R = 42 x 48 = 2,016 rows, D = 512, F = 2048), dropout
0.1, each with its device time by launch (torch.profiler over 5 calls,
the mean of each kernel's launches).
CUDA events over 20 calls after 3 warm-up calls. Each checkout runs in its
own process, which builds that checkout's FF libraries (and no other)
into its own `build/kernels/`. The checkouts run in the order given and then in
reverse (A, B, B, A for two), so that drift of the card's clocks shows as
a spread and not as a difference:

    python3 tools/torch_ffn_ab.py PARENT_CHECKOUT . [--dtype float32]

prints the card's name and power limit, one line per run and case and,
last, one JSON object {"device": ..., "runs": [{"tree": ..., "case": ...,
"ms": ..., "split": {kernel: ms}}, ...]}. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

D, F = 512, 2048
SEED = (0x0BADF00D, 0x5EED1234)
# case: (function, rows, dropout rate), by dtype
CASES = {"bfloat16": {"ff_backward train": ("ff_backward", 32 * 493, 0.1),
                      "ff_forward train": ("ff_forward", 32 * 493, 0.1),
                      "ff_forward serve": ("ff_forward", 8 * 599, 0.0)},
         "float32": {"ff_backward f32 crf-v1": ("ff_backward", 32 * 493, 0.1),
                     "ff_backward f32 danp": ("ff_backward", 42 * 48, 0.1)}}


def split_ms(call, calls=5):
    """{kernel: mean device ms a launch} over `calls` calls
    (torch.profiler); each kernel of the FF backward launches once a
    call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    total, seen = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n = e.name.replace("(anonymous namespace)::", "")
            n = n.replace("void ", "").split("(")[0][:48]
            total[n] = total.get(n, 0.0) + (e.time_range.end
                                            - e.time_range.start) / 1e3
            seen[n] = seen.get(n, 0) + 1
    return {n: total[n] / seen[n] for n in total}


def child(tree: str, dtype: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from cat_tpu_torch import _build
    from cat_tpu_torch.ops import ffn
    _build.SOURCES = (("ffn_f32",) if dtype == "float32"
                      else ("ffn_fwd", "ffn_bwd"))
    if not os.path.abspath(ffn.__file__).startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {ffn.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    wt = getattr(torch, dtype)

    def rnd(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * s).to(dtype)

    cases = CASES[dtype]
    R = max(rows for _, rows, _ in cases.values())
    x = rnd(R, D, dtype=wt)
    do = rnd(R, D, dtype=wt)
    p = (1 + rnd(D, s=0.1), rnd(D, s=0.1),
         rnd(D, F, s=D ** -0.5, dtype=wt), rnd(F, s=0.1),
         rnd(F, D, s=F ** -0.5, dtype=wt), rnd(D, s=0.1))
    out = {}
    for case, (fn, rows, rate) in cases.items():
        kw = dict(alpha=0.5, rate=rate, seed=SEED)
        xr, dr = x[:rows], do[:rows]
        if fn == "ff_backward":
            call = lambda: ffn.ff_backward(xr, *p, dr, **kw)  # noqa: E731
        else:
            call = lambda: ffn.ff_forward(xr, *p, **kw)  # noqa: E731
        for _ in range(3):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        out[case] = {"ms": start.elapsed_time(end) / 20,
                     "split": split_ms(call) if dtype == "float32" else {}}
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts of this repo")
    ap.add_argument("--dtype", choices=sorted(CASES), default="bfloat16")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.trees[0], args.dtype)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for tree in args.trees + args.trees[::-1]:
        tree = os.path.abspath(tree)
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", tree, "--dtype", args.dtype],
                             capture_output=True, text=True, cwd=tree)
        if out.returncode != 0:
            raise SystemExit(f"{tree}: exit {out.returncode}\n"
                             f"{out.stderr[-4000:]}")
        for case, r in json.loads(out.stdout.strip().splitlines()[-1]).items():
            fn, rows, rate = CASES[args.dtype][case]
            runs.append({"tree": tree, "case": case, **r})
            split = ", ".join(f"{k} {v:.4f}" for k, v in r["split"].items())
            print(f"{case} {tree}: {r['ms']:.4f} ms (R={rows}, D={D}, F={F}, "
                  f"rate {rate}, {args.dtype})"
                  + (f"; device by launch: {split}" if split else ""),
                  flush=True)
    print(json.dumps({"device": smi, "runs": runs}))


if __name__ == "__main__":
    main()
