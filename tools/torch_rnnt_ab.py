"""Time the RNN-T lattice kernels of several checkouts of this repo on one
card, measure the recursions' dependent-step floors, or time both routes
of this checkout's `csrc/rnnt.cu` across the wavefront's cut.

`cat_tpu_torch.ops.rnnt.forward_alphas` (PERF.md §6 row 20) and
`backward_betas` (row 21) on the tables (`_row_tables`) of chip_smoke.py's
rnnt-v1 training batch (N = 32, T' = 299..493, labels U_n = T'_n // 6 =
49..82, U+1 = 83, log-softmaxed random logits over V = 1024) and at U+1 =
257 (labels U_n = 256 - 3n, V = 9: the row-scan route of `rnnt_plan`),
CUDA events over 20 calls after 3 warm-up calls.

    python3 tools/torch_rnnt_ab.py PARENT_CHECKOUT .

runs each checkout in its own process (which builds that checkout's rnnt
library into its own `build/kernels/`), in the order given and then in
reverse (A, B, B, A for two), so that drift of the card's clocks shows as
a spread and not as a difference.

    python3 tools/torch_rnnt_ab.py --floor

measures t_step, the latency of one dependent step of each recursion in
its kernel's own arithmetic (`rnnt.chain_floor`: the wavefront's f64
`lae_wide` of two floored sums, its floor and one shuffle;
`ctc.chain_floor`: `lae3`, an added weight, its floor, two shuffles),
walked with no loads on 32 blocks of one warp. t_step = (time of 10 x 575
steps - time of 575 steps) / (9 x 575), which takes the launch out.
Prints the chain terms steps x t_step of PERF.md §6's bounds.

    python3 tools/torch_rnnt_ab.py --cut

builds a copy of this checkout's `rnnt.cu` whose C entries take the row
scan at any U+1 (and the wavefront where `rnnt_plan` gives it) and times
both routes at U+1 = 83 (the rnnt-v1 batch), 257, 512, 768 and 1024
(labels U_n = U - 3n, V = 9, the training batch's frames), each route's
states against the plain version on f64 copies of the tables (the
witness) at chip_smoke.py's state gate, printed as pass or FAIL. This
sets `rnnt_plan`'s cut.

    python3 tools/torch_rnnt_ab.py --ablate

times the wavefront at the rnnt-v1 batch as built (table values loaded
16 steps ahead; `lae_wide`'s correction by `__expf` and `__logf`) and in
copies of `rnnt.cu` that load 4 or 8 steps ahead or take the accurate
`expf` and `log1pf`, each held to the witness as `--cut` does.

Prints the card's name and power limit, one line per run and, last, one
JSON object {"device": ..., "runs": [{"tree" or "variant": ..., "case":
..., "ms": ...}, ...]}. Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_FRAMES = [1200 + 25 * k for k in range(32)]
LOG_EPS = -1e30
STATE_ATOL, STATE_RTOL = 1e-3, 2e-6
FLOOR_STEPS = 575
CUT_U1 = (83, 257, 512, 768, 1024)


def _subsampled(frames):
    return max(((frames - 1) // 2 - 1) // 2, 1)


def tables(torch, rnnt, U1):
    """(blank_eff, label_eff, beta_term) at the training batch's frames:
    U+1 = 83 the rnnt-v1 batch, else labels U_n = U1 - 1 - 3n over V = 9."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    tl = [_subsampled(f) for f in TRAIN_FRAMES]
    N, T = len(tl), max(tl)
    if U1 == 83:
        llens, V = [t // 6 for t in tl], 1024
    else:
        llens, V = [U1 - 1 - 3 * n for n in range(N)], 9
    assert max(llens) + 1 == U1
    lens = torch.tensor(tl, device="cuda")
    ll = torch.tensor(llens, device="cuda")
    labels = torch.randint(1, V, (N, U1 - 1), generator=gen, device="cuda")
    labels *= torch.arange(U1 - 1, device="cuda")[None, :] < ll[:, None]
    lp = torch.log_softmax(torch.randn(N, T, U1, V, generator=gen,
                                       device="cuda") * 2, -1)
    be, le, _, _ = rnnt._row_tables(lp, labels, lens, ll, 0)
    del lp
    torch.cuda.empty_cache()
    return be, le, rnnt.beta_term(ll, U1)


CASES = {"rnnt-v1 U+1=83": 83, "U+1=257": 257}


def timed(torch, fn, iters=20, warmup=3):
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
    from cat_tpu_torch import _build
    from cat_tpu_torch.ops import rnnt
    if not os.path.abspath(rnnt.__file__).startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {rnnt.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    _build.SOURCES = ("rnnt",)  # build this library alone
    out = {}
    for case, U1 in CASES.items():
        be, le, term = tables(torch, rnnt, U1)
        out[f"alpha {case}"] = timed(torch,
                                     lambda: rnnt.forward_alphas(be, le))
        out[f"beta {case}"] = timed(
            torch, lambda: rnnt.backward_betas(be, le, term))
    print(json.dumps(out))


def floor() -> list:
    sys.path.insert(0, REPO)
    import torch
    from cat_tpu_torch import _build
    from cat_tpu_torch.ops import ctc, rnnt
    _build.SOURCES = ("rnnt", "ctc")
    out = torch.empty(32, 32, device="cuda")
    runs, t_step = [], {}
    for name, mod in (("rnnt", rnnt), ("ctc", ctc)):
        ms = [timed(torch, lambda: mod.chain_floor(out, k * FLOOR_STEPS))
              for k in (1, 10)]
        t_step[name] = (ms[1] - ms[0]) / (9 * FLOOR_STEPS)
        print(f"floor {name}: {FLOOR_STEPS} steps {ms[0]:.4f} ms, "
              f"{10 * FLOOR_STEPS} steps {ms[1]:.4f} ms; t_step "
              f"{t_step[name] * 1e6:.2f} ns (32 blocks of one warp)",
              flush=True)
        runs.append({"variant": f"floor {name}", "case": "t_step",
                     "ms": t_step[name]})
    for row, steps, kind in (("rows 20-21 (T' + U = 575)", 575, "rnnt"),
                             ("rows 18-19 (T' = 493)", 493, "ctc")):
        print(f"chain term {row}: {steps} x {kind} t_step = "
              f"{steps * t_step[kind]:.4f} ms", flush=True)
    return runs


ONE_ROUTE = "    return route == WAVEFRONT && warps == (U1 + 31) / 32;"
EITHER_ROUTE = "    return warps == (route == WAVEFRONT ? (U1 + 31) / 32 : 0);"
PREFETCH = "constexpr int PREFETCH = 16;"
FAST_LAE = ": mx + (double)__logf(1.f + __expf((float)(mn - mx)));"
# variant: edits of rnnt.cu (each must match once)
VARIANTS = {
    "either route": [(ONE_ROUTE, EITHER_ROUTE)],
    "prefetch 4": [(PREFETCH, PREFETCH.replace("16", "4"))],
    "prefetch 8": [(PREFETCH, PREFETCH.replace("16", "8"))],
    "expf, log1pf": [(FAST_LAE, FAST_LAE.replace(
        "__logf(1.f + __expf(", "log1pf(expf("))],
}


def build_variants(names, out_dir) -> dict:
    """{name: ctypes library} of copies of rnnt.cu edited as VARIANTS
    says, built at once."""
    from cat_tpu_torch import _build
    src = open(os.path.join(REPO, "cat_tpu_torch", "csrc", "rnnt.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not once in rnnt.cu")
            text = text.replace(old, new)
        tag = "".join(c if c.isalnum() else "_" for c in name)
        cu = os.path.join(out_dir, f"rnnt_{tag}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"librnnt_{tag}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        cdll = ctypes.CDLL(lib)
        for entry, n_ptr in (("rnnt_alpha", 3), ("rnnt_beta", 4)):
            getattr(cdll, entry).argtypes = (
                [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                + [ctypes.c_void_p])
        libs[name] = cdll
    return libs


def time_and_gate(torch, rnnt, lib, name, U1, route, warps) -> list:
    """Times alpha and beta of `lib` on one route at U+1 = U1 and holds
    their states against the witness (the plain versions on f64 copies of
    the tables) at chip_smoke.py's state gate; prints pass or FAIL."""
    be, le, term = tables(torch, rnnt, U1)
    wide = (be.double(), le.double(), term.double())
    want = (rnnt.forward_alphas_reference(*wide[:2]),
            rnnt.backward_betas_reference(*wide))
    oa, ob = torch.empty_like(be), torch.empty_like(be)
    code, stream = (rnnt.ROUTES.index(route), warps), \
        torch.cuda.current_stream().cuda_stream
    calls = {"alpha": lambda: lib.rnnt_alpha(
                 be.data_ptr(), le.data_ptr(), oa.data_ptr(), *be.shape,
                 *code, stream),
             "beta": lambda: lib.rnnt_beta(
                 be.data_ptr(), le.data_ptr(), term.data_ptr(),
                 ob.data_ptr(), *be.shape, *code, stream)}
    for fn in calls.values():
        if fn():
            raise SystemExit(f"{name} at U+1 = {U1}: launch refused")
    torch.cuda.synchronize()
    errs, ok = [], True
    for got, w in zip((oa, ob), want):
        live = w > LOG_EPS / 2
        err = (got - w)[live].abs()
        ok = ok and not got.isnan().any() and bool(
            (got[~live] <= LOG_EPS / 2).all()) and bool(
            (err <= STATE_ATOL + STATE_RTOL * w[live].abs()).all())
        errs.append(err.max().item())
    runs = []
    for kind, fn in calls.items():
        ms = timed(torch, fn)
        runs.append({"variant": name, "case": f"{kind} U+1={U1}", "ms": ms})
        print(f"{name:24s} {kind} U+1={U1}: {ms:.4f} ms", flush=True)
    print(f"{name:24s} U+1={U1} states vs the f64 witness "
          f"{'pass' if ok else 'FAIL'}: max err alpha {errs[0]:.4g}, beta "
          f"{errs[1]:.4g}", flush=True)
    torch.cuda.empty_cache()
    return runs


def cut() -> list:
    sys.path.insert(0, REPO)
    import torch
    from cat_tpu_torch.ops import rnnt
    lib = build_variants(["either route"],
                         os.path.join(REPO, "build", "rnnt_ab"))["either route"]
    runs = []
    for U1 in CUT_U1:
        for route, warps in (("rowscan", 0), rnnt.rnnt_plan(U1)):
            name = f"cut {route} W={warps}" if warps else f"cut {route}"
            runs += time_and_gate(torch, rnnt, lib, name, U1, route, warps)
    return runs


def ablate() -> list:
    sys.path.insert(0, REPO)
    import torch
    from cat_tpu_torch.ops import rnnt
    names = ["either route", "prefetch 4", "prefetch 8", "expf, log1pf"]
    libs = build_variants(names, os.path.join(REPO, "build", "rnnt_ab"))
    plan = rnnt.rnnt_plan(83)
    runs = []
    for name in names:
        label = "ablate as built" if name == "either route" else \
            f"ablate {name}"
        runs += time_and_gate(torch, rnnt, libs[name], label, 83, *plan)
    return runs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", help="checkouts of this repo")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--floor", action="store_true",
                    help="measure the recursions' dependent-step floors")
    ap.add_argument("--cut", action="store_true",
                    help="time both routes across the wavefront's cut")
    ap.add_argument("--ablate", action="store_true",
                    help="time the wavefront's prefetch depth and intrinsics")
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
            runs.append({"tree": tree, "case": case, "ms": ms})
            print(f"{case} {tree}: {ms:.4f} ms", flush=True)
    if args.floor:
        runs += floor()
    if args.cut:
        runs += cut()
    if args.ablate:
        runs += ablate()
    print(json.dumps({"device": smi, "runs": runs}))


if __name__ == "__main__":
    main()
