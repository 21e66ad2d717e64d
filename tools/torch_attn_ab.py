"""Time the rel-pos attention forward and backward, and the paths that run them, of several checkouts of this repo on one card.

`cat_tpu_torch.ops.attention.relpos_attention_forward` (PERF.md §6 row 2)
at chip_smoke.py's crf-v1 training batch (N = 32, T' = 299..493, H = 8,
Dh = 64, dropout 0.1) and serving batch (N = 8, T' = 97..599, rate 0),
and `relpos_attention_backward` (row 3) at the training batch, rate 0.1
(dO random, zero on padded rows), bf16, CUDA events over 20 calls after
3 warm-up calls; then, through
that checkout's own chip_smoke.py, the crf-v1 serving forward
(`phase_serving`'s model and batch, CUDA events over 20 forwards after
3) and the crf-v1 train step (`phase_training`: 5 timed steps after 2
warm-up, and the split of one step into encoder forward, loss forward,
loss backward and encoder backward); and the host cost of a call
(tensor maps, shared-memory attribute, register check, launches):
`ff_forward`, `glu_in_forward` and the attention forward on 64 rows (one
utterance of 64 frames, D = 512), where each launch takes the device a
few microseconds, so that back-to-back calls time the host, CUDA events
over 1000 calls after 50. Each checkout runs in its own
process, which builds that checkout's kernels into its own
`build/kernels/`. The checkouts run in the order given and then in
reverse (A, B, B, A for two), so that drift of the card's clocks shows as
a spread and not as a difference:

    python3 tools/torch_attn_ab.py PARENT_CHECKOUT .
    python3 tools/torch_attn_ab.py --kernel-only PARENT_CHECKOUT .

prints the card's name and power limit, one line per run and case and,
last, one JSON object {"device": ..., "runs": [{"tree": ..., "case": ...,
"ms": ..., ...}, ...]}. Needs a card.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys

H, DH = 8, 64


def _subsampled(frames):
    return max(((frames - 1) // 2 - 1) // 2, 1)


# utterance lengths after the subsampling: chip_smoke.py's batches
TRAIN = [_subsampled(1200 + 25 * k) for k in range(32)]
SERVE = [_subsampled(f) for f in (2400, 1600, 1400, 1200, 1000, 800, 600,
                                  400)]
# case: (lengths, dropout rate)
KERNEL_CASES = {"relpos_attention_forward train": (TRAIN, 0.1),
                "relpos_attention_forward serve": (SERVE, 0.0),
                "relpos_attention_backward train": (TRAIN, 0.1)}
SEED = (0x0BADF00D, 0x5EED1234)


def _time(call, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernels(attention, out):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * s).to(torch.bfloat16)

    for case, (lengths, rate) in KERNEL_CASES.items():
        N, T = len(lengths), max(lengths)
        lt = torch.tensor(lengths, device="cuda")
        args = (rnd(N, T, H, DH), rnd(N, T, H, DH), rnd(N, T, H, DH),
                rnd(2 * T - 1, H, DH, s=0.5), rnd(H, DH, s=0.1),
                rnd(H, DH, s=0.1), lt)
        kw = dict(rate=rate, seed=SEED)
        if "backward" in case:
            o, lse = attention.relpos_attention_forward(*args, **kw)
            valid = torch.arange(T, device="cuda")[None, :] < lt[:, None]
            do = rnd(N, T, H, DH) * valid[..., None, None]
            call = lambda: attention.relpos_attention_backward(  # noqa: E731
                *args, o, lse, do, **kw)
        else:
            call = lambda: attention.relpos_attention_forward(  # noqa: E731
                *args, **kw)
        out[case] = {"ms": _time(call)}


def _host(attention, out):
    """Back-to-back calls on 64 rows: the host cost of a call."""
    import torch
    from cat_tpu_torch.ops import conv_module, ffn
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * s).to(dtype)

    bf, D, F, T = torch.bfloat16, 512, 2048, 64
    x = rnd(1, T, D, dtype=bf)
    mask = torch.ones(1, T, dtype=torch.bool, device="cuda")
    ffp = (1 + rnd(D, s=0.1), rnd(D, s=0.1),
           rnd(D, F, s=D ** -0.5, dtype=bf), rnd(F, s=0.1),
           rnd(F, D, s=F ** -0.5, dtype=bf), rnd(D, s=0.1))
    glp = (1 + rnd(D, s=0.1), rnd(D, s=0.1),
           rnd(D, 2 * D, s=D ** -0.5, dtype=bf), rnd(2 * D, s=0.1))
    att = (rnd(1, T, H, DH, dtype=bf), rnd(1, T, H, DH, dtype=bf),
           rnd(1, T, H, DH, dtype=bf), rnd(2 * T - 1, H, DH, dtype=bf),
           rnd(H, DH, dtype=bf), rnd(H, DH, dtype=bf),
           torch.tensor([T], device="cuda"))
    calls = {"ff_forward host": lambda: ffn.ff_forward(x, *ffp),
             "glu_in_forward host":
                 lambda: conv_module.glu_in_forward(x, mask, *glp),
             "relpos_attention_forward host":
                 lambda: attention.relpos_attention_forward(*att)}
    for case, call in calls.items():
        out[case] = {"ms": _time(call, 1000, 50)}


def _paths(smoke, out):
    """The serving forward and the crf-v1 train step of the checkout's
    chip_smoke.py; the train phase's own lines give the step."""
    import torch
    cfg = smoke.load_config()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        den = smoke.make_den()
        forward = smoke.phase_serving(cfg)
        out["serving forward"] = {"ms": _time(forward)}
        del forward
        torch.cuda.empty_cache()
        smoke.phase_training(cfg, den, False)
    text = log.getvalue()
    steps = re.search(r"timed steps: ([\d.]+) ms per step \(CUDA events; "
                      r"([\d.]+)\.\.([\d.]+)\)", text)
    split = re.search(r"encoder forward ([\d.]+), loss forward ([\d.]+), "
                      r"loss backward ([\d.]+), encoder backward ([\d.]+)",
                      text)
    if steps is None or split is None:
        raise SystemExit(f"no step lines in chip_smoke's output:\n{text}")
    out["crf-v1 step"] = {
        "ms": float(steps[1]), "min": float(steps[2]),
        "max": float(steps[3]),
        **dict(zip(("encoder_fwd", "loss_fwd", "loss_bwd", "encoder_bwd"),
                   map(float, split.groups())))}


def child(tree: str, kernel_only: bool) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import chip_smoke
    from cat_tpu_torch.ops import attention
    for mod in (chip_smoke, attention):
        if not os.path.abspath(mod.__file__).startswith(
                os.path.abspath(tree)):
            raise SystemExit(f"imported {mod.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    _kernels(attention, out)
    _host(attention, out)
    if not kernel_only:
        _paths(chip_smoke, out)
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts of this repo")
    ap.add_argument("--kernel-only", action="store_true",
                    help="time the kernels only, not the step and the "
                         "serving forward")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.trees[0], args.kernel_only)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for tree in args.trees + args.trees[::-1]:
        tree = os.path.abspath(tree)
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree]
        if args.kernel_only:
            cmd.append("--kernel-only")
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=tree)
        if out.returncode != 0:
            raise SystemExit(f"{tree}: exit {out.returncode}\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        for case, res in json.loads(
                out.stdout.strip().splitlines()[-1]).items():
            runs.append({"tree": tree, "case": case, **res})
            extra = ", ".join(f"{k} {v}" for k, v in res.items() if k != "ms")
            print(f"{case} {tree}: {res['ms']:.4f} ms"
                  + (f" ({extra})" if extra else ""), flush=True)
    print(json.dumps({"device": smi, "runs": runs}))


if __name__ == "__main__":
    main()
