"""Time the standalone dropout (PERF.md §6 row 1) of several checkouts of
this repo on one card, device time and host cost apart.

`cat_tpu_torch.ops.dropout.dropout_apply` at rate 0.1 at row 1's two
shapes on the main path: chip_smoke.py's crf-v1 training batch after the
subsampling (32 x 493 x 512 bf16) and the llm-p2g danp decoder's
feed-forward output (42 x 46 x 512 f32), with `torch.nn.functional.dropout`
on the same tensor beside it. For each: CUDA events over 20 back-to-back
calls after 3 warm-up calls (the larger of the host's and the card's
pace), the device time of a call (torch.profiler over 20 calls) and the
host's cost of a call (200 back-to-back calls that wait for nothing, on
the host clock); events and host cost the medians of 5 rounds in which
the two calls take turns, since the host's pace drifts. Each checkout
runs in its own process, which builds that checkout's dropout library
into its own `build/kernels/`; the checkouts run in the order given and
then in reverse (A, B, B, A for two):

    python3 tools/torch_dropout_ab.py PARENT_CHECKOUT .

prints the card's name and power limit, one line per run and case and,
last, one JSON object {"device": ..., "runs": [{"tree": ..., "case": ...,
"ms": ..., "device_ms": ..., "host_us": ..., "library": {...}}, ...]}.
Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SEED = (0x0BADF00D, 0x5EED1234)
CASES = {"crf-v1 batch": ((32, 493, 512), "bfloat16"),
         "P2G decoder FF output": ((42, 46, 512), "float32")}


def measure(kernel, library, rounds=5):
    """{"ms", "device_ms", "host_us"} of each of two calls: CUDA events over
    20 back-to-back calls, the median of `rounds` rounds with the two
    interleaved; the device time of a call, the mean of its launches over
    20 calls (torch.profiler; each call one launch);
    the host's cost of a call, the median of `rounds` rounds of 200."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    calls = {"kernel": kernel, "library": library}
    ev = {k: [] for k in calls}
    host = {k: [] for k in calls}
    for _ in range(rounds):
        for k, call in calls.items():
            for _ in range(3):
                call()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            ev[k].append(start.elapsed_time(end) / 20)
            t = time.perf_counter()
            for _ in range(200):
                call()
            host[k].append((time.perf_counter() - t) / 200 * 1e6)
            torch.cuda.synchronize()
    out = {}
    for k, call in calls.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start
                 for e in prof.events() if e.device_type == DeviceType.CUDA]
        dev = sum(spans) / max(len(spans), 1) / 1e3  # a call: one launch
        out[k] = {"ms": sorted(ev[k])[rounds // 2], "device_ms": dev,
                  "host_us": sorted(host[k])[rounds // 2]}
    return out


def child(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as F
    from cat_tpu_torch import _build
    from cat_tpu_torch.ops import dropout
    if not os.path.abspath(dropout.__file__).startswith(
            os.path.abspath(tree)):
        raise SystemExit(f"imported {dropout.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    _build.SOURCES = ("dropout",)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for case, (shape, dtype) in CASES.items():
        x = torch.randn(*shape, generator=gen, device="cuda").to(
            getattr(torch, dtype))
        if not torch.equal(dropout.dropout_apply(x, 0.1, SEED),
                           dropout.dropout_reference(x, 0.1, SEED)):
            raise SystemExit(f"{tree}: dropout at {case} is not its plain "
                             f"version bit for bit")
        m = measure(lambda: dropout.dropout_apply(x, 0.1, SEED),
                    lambda: F.dropout(x, 0.1, True))
        out[case] = {**m["kernel"], "library": m["library"]}
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
        for case, r in json.loads(out.stdout.strip().splitlines()[-1]).items():
            shape, dtype = CASES[case]
            runs.append({"tree": tree, "case": case, **r})
            lib = r["library"]
            print(f"{case} {shape} {dtype} {tree}: {r['ms']:.4f} ms (device "
                  f"{r['device_ms']:.4f} ms, host {r['host_us']:.1f} us a "
                  f"call); F.dropout {lib['ms']:.4f} ms (device "
                  f"{lib['device_ms']:.4f} ms, host {lib['host_us']:.1f} us)",
                  flush=True)
    print(json.dumps({"device": smi, "runs": runs}))


if __name__ == "__main__":
    main()
