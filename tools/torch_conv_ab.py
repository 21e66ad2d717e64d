"""Time the conv module's kernels of several checkouts of this repo on one card.

`cat_tpu_torch.ops.conv_module.glu_in_backward` (PERF.md §6 row 15),
`glu_in_forward` (row 14), `bn_out_backward` (row 17) and
`bn_out_forward` (row 16) at chip_smoke.py's crf-v1 training batch
(R = 32 x 493 = 15,776 rows, D = 512) and serving batch (R = 8 x 599 =
4,792 rows), bf16, with the valid-frame mask of each batch's utterance
lengths; bn_out at dropout 0.1 as in training, its forward at the
serving batch at 0 as in serving, and on 64 rows (the host cost of a
call); CUDA events over 20 calls after 3 warm-up calls. Each checkout
runs in its own process, which builds that checkout's kernels into its
own `build/kernels/`. The checkouts run in the order given and then in
reverse (A, B, B, A for two), so that drift of the card's clocks shows as
a spread and not as a difference:

    python3 tools/torch_conv_ab.py PARENT_CHECKOUT .

prints the card's name and power limit, one line per run and case and,
last, one JSON object {"device": ..., "runs": [{"tree": ..., "case": ...,
"ms": ...}, ...]}. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

D = 512


def _subsampled(frames):
    return max(((frames - 1) // 2 - 1) // 2, 1)


# utterance lengths after the subsampling: chip_smoke.py's batches
TRAIN = [_subsampled(1200 + 25 * k) for k in range(32)]
SERVE = [_subsampled(f) for f in (2400, 1600, 1400, 1200, 1000, 800, 600,
                                  400)]
SEED = (0x2468ACE0, 0x13579BDF)
# case: (function, lengths, dropout rate)
CASES = {"glu_in_backward train": ("glu_in_backward", TRAIN, 0.0),
         "glu_in_forward train": ("glu_in_forward", TRAIN, 0.0),
         "glu_in_backward serve": ("glu_in_backward", SERVE, 0.0),
         "glu_in_forward serve": ("glu_in_forward", SERVE, 0.0),
         "bn_out_backward train": ("bn_out_backward", TRAIN, 0.1),
         "bn_out_forward train": ("bn_out_forward", TRAIN, 0.1),
         "bn_out_backward serve": ("bn_out_backward", SERVE, 0.1),
         "bn_out_forward serve": ("bn_out_forward", SERVE, 0.0),
         # 64 rows: the device work is a few microseconds, the rest is the
         # host cost of a call (wrapper, tensor maps, launches)
         "bn_out_forward 64 rows": ("bn_out_forward", [64], 0.1)}


def child(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from cat_tpu_torch.ops import conv_module
    if not os.path.abspath(conv_module.__file__).startswith(
            os.path.abspath(tree)):
        raise SystemExit(f"imported {conv_module.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * s).to(dtype)

    p = (1 + rnd(D, s=0.1), rnd(D, s=0.1),
         rnd(D, 2 * D, s=D ** -0.5, dtype=torch.bfloat16), rnd(2 * D, s=0.1))
    bn = (rnd(D, s=0.1), 1 + rnd(D, s=0.2).abs(), 1 + rnd(D, s=0.1),
          rnd(D, s=0.1), rnd(D, D, s=D ** -0.5, dtype=torch.bfloat16),
          rnd(D, s=0.1))
    out = {}
    for case, (fn, lengths, rate) in CASES.items():
        N, T = len(lengths), max(lengths)
        x = rnd(N, T, D, dtype=torch.bfloat16)
        c = rnd(N, T, D, dtype=torch.bfloat16)
        do = rnd(N, T, D, dtype=torch.bfloat16)
        mask = (torch.arange(T, device="cuda")[None, :]
                < torch.tensor(lengths, device="cuda")[:, None])
        kw = dict(rate=rate, seed=SEED)
        call = {
            "glu_in_backward":
                lambda: conv_module.glu_in_backward(x, mask, *p, do),
            "glu_in_forward": lambda: conv_module.glu_in_forward(x, mask, *p),
            "bn_out_backward":
                lambda: conv_module.bn_out_backward(c, x, mask, *bn, do, **kw),
            "bn_out_forward":
                lambda: conv_module.bn_out_forward(c, x, mask, *bn, **kw),
        }[fn]
        for _ in range(3):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        out[case] = start.elapsed_time(end) / 20
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts of this repo")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.trees[0])
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
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
            fn, lengths, rate = CASES[case]
            runs.append({"tree": tree, "case": case, "ms": ms})
            print(f"{fn} {tree}: {ms:.4f} ms (R={len(lengths) * max(lengths)},"
                  f" {sum(lengths)} valid, D={D}, rate {rate})", flush=True)
    print(json.dumps({"device": smi, "runs": runs}))


if __name__ == "__main__":
    main()
