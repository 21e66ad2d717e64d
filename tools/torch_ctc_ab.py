"""Time the CTC lattice kernels of several checkouts of this repo on one
card, measure the recursion's dependent-step floor, time both routes of
this checkout's `csrc/ctc.cu` across the lanes route's cut, or time
variants of the lanes route.

`cat_tpu_torch.ops.ctc.forward_alphas` (PERF.md §6 row 18) and
`backward_betas` (row 19) on the emission table (`_emissions`) of
chip_smoke.py's crf-v1 training batch (N = 32, T' = 299..493, labels U_n =
T'_n // 4 = 74..123 ids in 1..71, S = 247, log-softmaxed random logits
over V = 72) and at S = 511, 1023, 1025, 2047 and 6001 (labels U_n = (S -
1) / 2 - 3n on the same frames; below 247, U_n = (S - 1) / 2 - n mod 3),
CUDA events over 20 calls after 3 warm-up calls (20 in a checkout's own
process, whose first case would otherwise meet the card's clocks
rising).

    python3 tools/torch_ctc_ab.py PARENT_CHECKOUT .

runs each checkout in its own process (which builds that checkout's ctc
library into its own `build/kernels/`), in the order given and then in
reverse (A, B, B, A for two), so that drift of the card's clocks shows as
a spread and not as a difference.

    python3 tools/torch_ctc_ab.py --floor

measures t_step, the latency of one dependent step of the recursion in
its kernels' own arithmetic (`ctc.chain_floor`: `lae3` of a state and two
neighbours, an added weight, its floor, two shuffles), walked with no
loads on 32 blocks of one warp: t_step = (time of 10 x 575 steps - time
of 575 steps) / (9 x 575), which takes the launch out. Prints the chain
term 493 x t_step of rows 18-19's bounds.

    python3 tools/torch_ctc_ab.py --cut

builds a copy of this checkout's `ctc.cu` whose C entries take the frames
route at any S (and the lanes route where `ctc_plan` gives it) and times
both routes at S = 247 (the crf-v1 batch), 511, 1023, 1025, 2047 and 6001,
each route held to the plain versions at PERF.md §2's gates (states,
log-likelihoods, gradient rows), printed as pass or FAIL.

    python3 tools/torch_ctc_ab.py --ablate

times the lanes route at the crf-v1 batch as built (emissions loaded 16
frames ahead, one barrier a frame, one state a thread, `lae3` by the
accurate `expf` and `logf`, streaming stores) and in copies of `ctc.cu`
that load 4 or 8 frames ahead; pass the seam by per-warp flags in shared
memory (a warp waits for the one it reads from to have written, and for
the one that reads it to have read) in place of the barrier; hold two
states a lane (states 2l and 2l + 1 in lane l, on half the warps); take
`__expf` and `__logf` (also timed and gated at S = 6001, the frames
route); take `logf` on every lane and a select where the compiler
branches round it; load the emissions by `__ldcg` or `__ldcs`; or store
the states without the streaming hint. Each variant's states,
log-likelihoods and gradient rows are held to the plain versions at
PERF.md §2's gates, printed as pass or FAIL. For timing only (their gates
fail by design), copies with the barrier, the state stores or the
emission loads taken out split the step, and the build as it is runs at
S = 31, 63 and 127 (one, two and four warps).

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
STATE_ATOL, STATE_RTOL, LL_RTOL, GRAD_TOL = 1e-3, 2e-6, 1e-5, 1e-3
FLOOR_STEPS = 575
CRF_V1_S = 247
CUT_S = (247, 511, 1023, 1025, 2047, 6001)
# the lanes route on 1 to 8 warps (the step's cost by the warps a block)
WARPS_S = (31, 63, 127, 247)


def _subsampled(frames):
    return max(((frames - 1) // 2 - 1) // 2, 1)


def tables(torch, ctc, S):
    """(log_probs, labels, input lengths, label lengths, em, allow2,
    allow2_dst, beta_last) at the training batch's frames: S = 247 the
    crf-v1 batch, else labels U_n = (S - 1) / 2 - 3n (below 247: - n mod
    3)."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    tl = [_subsampled(f) for f in TRAIN_FRAMES]
    N, T, V = len(tl), max(tl), 72
    if S == CRF_V1_S:
        llens = [t // 4 for t in tl]
    elif S < CRF_V1_S:
        llens = [(S - 1) // 2 - n % 3 for n in range(N)]
    else:
        llens = [(S - 1) // 2 - 3 * n for n in range(N)]
    assert 2 * max(llens) + 1 == S
    lens = torch.tensor(tl, device="cuda")
    ll = torch.tensor(llens, device="cuda")
    U = max(llens)
    labels = torch.randint(1, V, (N, U), generator=gen, device="cuda")
    labels *= torch.arange(U, device="cuda")[None, :] < ll[:, None]
    lp = torch.log_softmax(torch.randn(N, T, V, generator=gen,
                                       device="cuda") * 2, -1)
    ext, svalid, allow2 = ctc._lattice_tables(labels, ll, 0, S)
    em = ctc._emissions(lp, ext, svalid, lens, 0)
    return (lp, labels, lens, ll, em, allow2, *ctc._beta_tables(allow2, ll))


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
    from cat_tpu_torch.ops import ctc
    if not os.path.abspath(ctc.__file__).startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {ctc.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    _build.SOURCES = ("ctc",)  # build this library alone
    out = {}
    for S in CUT_S:
        _, _, _, _, em, a2, a2d, bl = tables(torch, ctc, S)
        case = "crf-v1 S=247" if S == CRF_V1_S else f"S={S}"
        out[f"alpha {case}"] = timed(
            torch, lambda: ctc.forward_alphas(em, a2), warmup=20)
        out[f"beta {case}"] = timed(
            torch, lambda: ctc.backward_betas(em, a2d, bl), warmup=20)
        del em
        torch.cuda.empty_cache()
    print(json.dumps(out))


def floor() -> list:
    sys.path.insert(0, REPO)
    import torch
    from cat_tpu_torch import _build
    from cat_tpu_torch.ops import ctc
    _build.SOURCES = ("ctc",)
    out = torch.empty(32, 32, device="cuda")
    ms = [timed(torch, lambda: ctc.chain_floor(out, k * FLOOR_STEPS))
          for k in (1, 10)]
    t_step = (ms[1] - ms[0]) / (9 * FLOOR_STEPS)
    print(f"floor ctc: {FLOOR_STEPS} steps {ms[0]:.4f} ms, "
          f"{10 * FLOOR_STEPS} steps {ms[1]:.4f} ms; t_step "
          f"{t_step * 1e6:.2f} ns (32 blocks of one warp)", flush=True)
    print(f"chain term rows 18-19 (T' = 493): 493 x t_step = "
          f"{493 * t_step:.4f} ms", flush=True)
    return [{"variant": "floor ctc", "case": "t_step", "ms": t_step}]


ONE_ROUTE = "    return route == LANES && warps == (S + 31) / 32;"
EITHER_ROUTE = "    return warps == (route == LANES ? (S + 31) / 32 : 0);"
PREFETCH = "constexpr int PREFETCH = 16;"
ACCURATE = ("  const float s = expf(a - ms) + expf(b - ms) + expf(c - ms);\n"
            "  return m <= LOG_EPS / 2 ? LOG_EPS : ms + logf(s);")
# the flags seam: acquire / release on shared memory, and a wait that
# traps after about 4 s instead of hanging the card
FLAG_HELPERS = r'''
#ifdef __CUDA_ARCH__
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v) : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;"
               :: "r"((unsigned)__cvta_generic_to_shared(p)), "r"(v)
               : "memory");
}
#else
inline int ld_acquire(const int* p) {
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
}
inline void st_release(int* p, int v) {
  __atomic_store_n(p, v, __ATOMIC_RELEASE);
}
#endif
__device__ __forceinline__ void wait_at_least(const int* p, int v) {
  const long long t0 = clock64();
  while (ld_acquire(p) < v)
    if (clock64() - t0 > (1ll << 33)) __trap();
}

// Lanes route: grid N'''
# two states a lane: lane l of warp w holds states 64 w + 2 l and + 1
PAIRS_KERNEL = r'''
template <bool kBeta, int kMaxWarps>
__global__ void __launch_bounds__(32 * kMaxWarps)
    ctc_pairs_kernel(const float* __restrict__ em,
                     const unsigned char* __restrict__ skip,
                     const float* __restrict__ beta_last,
                     float* __restrict__ out, int T, int N, int S) {
  __shared__ float seam[2][kMaxWarps][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5, n = blockIdx.x;
  const int s0 = 64 * warp + 2 * lane;
  const bool on0 = s0 < S, on1 = s0 + 1 < S;
  const size_t st = (size_t)N * S;
  const size_t at = (size_t)n * S + s0;
  const int from = kBeta ? warp + 1 : warp - 1;
  const bool has_from = from >= 0 && from < W;
  const bool edge = kBeta ? lane == 31 : lane == 0;
  const bool sends = kBeta ? lane == 0 : lane == 31;
  const bool sk0 = on0 && (kBeta ? s0 + 2 < S : s0 >= 2) && skip[at];
  const bool sk1 = on1 && (kBeta ? s0 + 3 < S : s0 >= 1) && skip[at + 1];
  const int K = kBeta ? T - 1 : T, E = kBeta ? T - 2 : T;
  const long long dk = kBeta ? -(long long)st : (long long)st;
  long long o_out = (long long)(kBeta ? T - 2 : 0) * (long long)st + at;
  long long o_em = o_out;
  float r0[PREFETCH], r1[PREFETCH];
#pragma unroll
  for (int j = 0; j < PREFETCH; ++j, o_em += dk) {
    r0[j] = on0 && j < E ? em[o_em] : LOG_EPS;
    r1[j] = on1 && j < E ? em[o_em + 1] : LOG_EPS;
  }
  float v0, v1;
  if (kBeta) {
    const size_t lt = (size_t)(T - 1) * st + at;
    const float l0 = on0 ? beta_last[at] : LOG_EPS;
    const float l1 = on1 ? beta_last[at + 1] : LOG_EPS;
    if (on0) out[lt] = l0;
    if (on1) out[lt + 1] = l1;
    v0 = fmaxf((on0 ? em[lt] : LOG_EPS) + l0, LOG_EPS);
    v1 = fmaxf((on1 ? em[lt + 1] : LOG_EPS) + l1, LOG_EPS);
  } else {
    v0 = s0 == 0 ? 0.f : LOG_EPS;
    v1 = LOG_EPS;
  }
  const int fc = has_from ? from : warp;
  if (sends) {
    seam[1][warp][0] = v0;
    seam[1][warp][1] = v1;
  }
  if (W > 1) __syncthreads();
  for (int k0 = 0; k0 < K; k0 += PREFETCH) {
#pragma unroll
    for (int j = 0; j < PREFETCH; ++j) {
      const int k = k0 + j;
      if (k >= K) break;
      const float x0 = r0[j], x1 = r1[j];
      r0[j] = on0 && k + PREFETCH < E ? em[o_em] : LOG_EPS;
      r1[j] = on1 && k + PREFETCH < E ? em[o_em + 1] : LOG_EPS;
      o_em += dk;
      float p0 = kBeta ? __shfl_down_sync(FULL, v0, 1)
                       : __shfl_up_sync(FULL, v0, 1);
      float p1 = kBeta ? __shfl_down_sync(FULL, v1, 1)
                       : __shfl_up_sync(FULL, v1, 1);
      const float e0 = seam[(k + 1) & 1][fc][0];
      const float e1 = seam[(k + 1) & 1][fc][1];
      if (edge) {
        p0 = has_from ? e0 : LOG_EPS;
        p1 = has_from ? e1 : LOG_EPS;
      }
      float y0, y1;
      if (kBeta) {
        y0 = fmaxf(lae3(v0, v1, sk0 ? p0 : LOG_EPS), LOG_EPS);
        y1 = fmaxf(lae3(v1, p0, sk1 ? p1 : LOG_EPS), LOG_EPS);
        v0 = fmaxf(x0 + y0, LOG_EPS);
        v1 = fmaxf(x1 + y1, LOG_EPS);
      } else {
        y0 = fmaxf(x0 + lae3(v0, p1, sk0 ? p0 : LOG_EPS), LOG_EPS);
        y1 = fmaxf(x1 + lae3(v1, v0, sk1 ? p1 : LOG_EPS), LOG_EPS);
        v0 = y0;
        v1 = y1;
      }
      if (on0) out[o_out] = y0;
      if (on1) out[o_out + 1] = y1;
      o_out += dk;
      if (W > 1) {
        if (sends) {
          seam[k & 1][warp][0] = v0;
          seam[k & 1][warp][1] = v1;
        }
        __syncthreads();
      }
    }
  }
}

// Frames route launch shape'''
LAUNCH = '''  if (warps <= LANES_NARROW_WARPS)
    ctc_lanes_kernel<kBeta, LANES_NARROW_WARPS><<<N, 32 * warps, 0, st>>>(
        em, skip, last, out, T, N, S);
  else
    ctc_lanes_kernel<kBeta, LANES_MAX_WARPS><<<N, 32 * warps, 0, st>>>(
        em, skip, last, out, T, N, S);'''
PAIRS_LAUNCH = '''  const int w2 = (S + 63) / 64;
  if (w2 <= LANES_NARROW_WARPS)
    ctc_pairs_kernel<kBeta, LANES_NARROW_WARPS><<<N, 32 * w2, 0, st>>>(
        em, skip, last, out, T, N, S);
  else
    ctc_pairs_kernel<kBeta, LANES_MAX_WARPS / 2><<<N, 32 * w2, 0, st>>>(
        em, skip, last, out, T, N, S);'''
SEAM_READ = "      // the edge lanes take the neighbouring warp's values of step k - 1;"
SEAM_WRITE = '''      if (W > 1) {
        if (r >= 30) seam[k & 1][warp][31 - r] = v;
        __syncthreads();
      }'''
FLAGS_WRITE = '''      if (has_to) wait_at_least(&prog[to], k);
      if (r >= 30) seam[k & 1][warp][31 - r] = v;
      __syncwarp();
      if (r == 31) st_release(&prog[warp], k + 1);'''
STORE = "      if (on) __stcs(out + o_out, y);"
RING = "      ring[j] = on && k + PREFETCH < E ? em[o_em] : LOG_EPS;"
LAE3_RETURN = "  return m <= LOG_EPS / 2 ? LOG_EPS : ms + logf(s);"
# variant: edits of ctc.cu (each must match once)
VARIANTS = {
    "either route": [(ONE_ROUTE, EITHER_ROUTE)],
    "prefetch 4": [(PREFETCH, PREFETCH.replace("16", "4"))],
    "prefetch 8": [(PREFETCH, PREFETCH.replace("16", "8"))],
    "flags seam": [
        ("\n// Lanes route: grid N", FLAG_HELPERS),
        ("  __shared__ float seam[2][kMaxWarps][2];\n",
         "  __shared__ float seam[2][kMaxWarps][2];\n"
         "  __shared__ int prog[kMaxWarps];\n"),
        ("  const bool has_from = from >= 0 && from < W;\n  // the skip",
         "  const bool has_from = from >= 0 && from < W;\n"
         "  const int to = kBeta ? warp - 1 : warp + 1;\n"
         "  const bool has_to = to >= 0 && to < W;\n  // the skip"),
        ("  if (r >= 30) seam[1][warp][31 - r] = v;\n",
         "  if (r >= 30) seam[1][warp][31 - r] = v;\n"
         "  if (lane == 0) prog[warp] = 0;\n"),
        (SEAM_READ, "      if (has_from) wait_at_least(&prog[from], k);\n"
         + SEAM_READ),
        (SEAM_WRITE, FLAGS_WRITE)],
    "two states a lane": [("\n// Frames route launch shape", PAIRS_KERNEL),
                          (LAUNCH, PAIRS_LAUNCH)],
    "__expf, __logf": [(ACCURATE, ACCURATE.replace("expf(", "__expf(")
                        .replace("logf(s)", "__logf(s)"))],
    # logf on every lane and a select, where the compiler branches round it
    "lae3 by select": [(LAE3_RETURN,
                        "  float l = logf(s);\n"
                        "  asm volatile(\"\" : \"+f\"(l));\n"
                        "  return m <= LOG_EPS / 2 ? LOG_EPS : ms + l;")],
    # the cache operators of the emission loads and the state stores
    "loads __ldcg": [(RING, RING.replace("em[o_em]", "__ldcg(em + o_em)"))],
    "loads __ldcs": [(RING, RING.replace("em[o_em]", "__ldcs(em + o_em)"))],
    "stores without .cs": [(STORE, STORE.replace("__stcs(out + o_out, y)",
                                                 "out[o_out] = y"))],
    # parts taken out, for timing only (their gates fail by design)
    "timing only: no barrier": [(SEAM_WRITE, SEAM_WRITE.replace(
        "        __syncthreads();\n", ""))],
    "timing only: no state stores": [(STORE, STORE.replace(
        "if (on)", "if (on && k == K - 1)"))],
    "timing only: no emission loads": [(RING, "      ring[j] = x * 0.5f;")],
}
TIMING_ONLY = [n for n in VARIANTS if n.startswith("timing only")]


def variant_source(name) -> str:
    """This checkout's ctc.cu edited as VARIANTS[name] says."""
    text = open(os.path.join(REPO, "cat_tpu_torch", "csrc", "ctc.cu")).read()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not once in ctc.cu")
        text = text.replace(old, new)
    return text


def build_variants(names, out_dir) -> dict:
    """{name: ctypes library} of copies of ctc.cu edited as VARIANTS says,
    built at once."""
    from cat_tpu_torch import _build
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        tag = "".join(c if c.isalnum() else "_" for c in name)
        cu = os.path.join(out_dir, f"ctc_{tag}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(name))
        lib = os.path.join(out_dir, f"libctc_{tag}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        regs = [ln.strip() for ln in log.splitlines() if "Used" in ln
                or ("spill" in ln and "0 bytes spill" not in ln)]
        print(f"{name}: ptxas {'; '.join(regs)}", flush=True)
        cdll = ctypes.CDLL(lib)
        for entry, n_ptr in (("ctc_alpha", 3), ("ctc_beta", 4)):
            getattr(cdll, entry).argtypes = (
                [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                + [ctypes.c_void_p])
        libs[name] = cdll
    return libs


def time_and_gate(torch, ctc, lib, name, S, route, warps) -> list:
    """Times alpha and beta of `lib` on one route at S and holds them to
    the plain versions at PERF.md §2's gates: states, the log-likelihoods
    and the gradient rows of `ctc_loss` (sum) with the kernels patched in;
    prints pass or FAIL."""
    lp, labels, lens, ll, em, a2, a2d, bl = tables(torch, ctc, S)
    code = (ctc.ROUTES.index(route), warps)
    stream = torch.cuda.current_stream().cuda_stream

    def alpha(em_, a2_):
        out = torch.empty_like(em_)
        if lib.ctc_alpha(em_.data_ptr(), a2_.data_ptr(), out.data_ptr(),
                         *em_.shape, *code, stream):
            raise SystemExit(f"{name} at S = {S}: launch refused")
        return out

    def beta(em_, a2d_, bl_):
        out = torch.empty_like(em_)
        if lib.ctc_beta(em_.data_ptr(), a2d_.data_ptr(), bl_.data_ptr(),
                        out.data_ptr(), *em_.shape, *code, stream):
            raise SystemExit(f"{name} at S = {S}: launch refused")
        return out

    def grad(fa, fb):
        x = lp.clone().requires_grad_()
        saved = ctc.forward_alphas, ctc.backward_betas
        ctc.forward_alphas, ctc.backward_betas = fa, fb
        try:
            ctc.ctc_loss(x, labels, lens, ll, reduction="sum").backward()
        finally:
            ctc.forward_alphas, ctc.backward_betas = saved
        return x.grad

    oa, ob = alpha(em, a2), beta(em, a2d, bl)
    pa = ctc.forward_alphas_reference(em, a2)
    pb = ctc.backward_betas_reference(em, a2d, bl)
    ok, errs = True, []
    for got, want in ((oa, pa), (ob, pb)):
        live = want > LOG_EPS / 2
        err = (got - want)[live].abs()
        ok = ok and not got.isnan().any() and bool(
            (got[~live] <= LOG_EPS / 2).all()) and bool(
            (err <= STATE_ATOL + STATE_RTOL * want[live].abs()).all())
        errs.append(err.max().item())
    lk, lw = ctc._final_ll(oa[-1], ll), ctc._final_ll(pa[-1], ll)
    e_ll = ((lk - lw).abs() / lw.abs().clamp_min(1e-30)).max().item()
    gk = grad(alpha, beta)
    gw = grad(ctc.forward_alphas_reference, ctc.backward_betas_reference)
    e_g = (gk - gw).abs().max().item()
    ok = ok and e_ll <= LL_RTOL and bool(
        ((gk - gw).abs() <= GRAD_TOL + GRAD_TOL * gw.abs()).all())
    same = torch.equal(alpha(em, a2), oa) and torch.equal(beta(em, a2d, bl),
                                                         ob)
    runs = []
    for kind, fn in (("alpha", lambda: alpha(em, a2)),
                     ("beta", lambda: beta(em, a2d, bl))):
        ms = timed(torch, fn)
        runs.append({"variant": name, "case": f"{kind} S={S}", "ms": ms})
        print(f"{name:26s} {kind} S={S}: {ms:.4f} ms", flush=True)
    print(f"{name:26s} S={S} {route} W={warps} gates "
          f"{'pass' if ok else 'FAIL'}: max err alpha {errs[0]:.4g}, beta "
          f"{errs[1]:.4g}, ll {e_ll:.3g} rel, gradient rows {e_g:.4g}; two "
          f"calls bit for bit {same}", flush=True)
    del em, oa, ob, pa, pb
    torch.cuda.empty_cache()
    return runs


def cut() -> list:
    sys.path.insert(0, REPO)
    import torch
    from cat_tpu_torch.ops import ctc
    lib = build_variants(["either route"],
                         os.path.join(REPO, "build", "ctc_ab"))["either route"]
    runs = []
    for S in CUT_S:
        for route, warps in dict.fromkeys([("frames", 0),
                                           tuple(ctc.ctc_plan(S))]):
            label = f"cut {route} W={warps}" if warps else f"cut {route}"
            runs += time_and_gate(torch, ctc, lib, label, S, route, warps)
    return runs


def ablate() -> list:
    sys.path.insert(0, REPO)
    import torch
    from cat_tpu_torch.ops import ctc
    names = ["either route", "prefetch 4", "prefetch 8", "flags seam",
             "two states a lane", "__expf, __logf", "lae3 by select",
             "loads __ldcg", "loads __ldcs", "stores without .cs",
             *TIMING_ONLY]
    libs = build_variants(names, os.path.join(REPO, "build", "ctc_ab"))
    runs = []
    for name in names:
        label = "ablate as built" if name == "either route" else \
            f"ablate {name}"
        runs += time_and_gate(torch, ctc, libs[name], label, CRF_V1_S,
                              *ctc.ctc_plan(CRF_V1_S))
    for S in WARPS_S[:-1]:
        runs += time_and_gate(torch, ctc, libs["either route"],
                              "ablate as built", S, *ctc.ctc_plan(S))
    for name in ("either route", "__expf, __logf"):
        label = "ablate as built" if name == "either route" else \
            f"ablate {name}"
        runs += time_and_gate(torch, ctc, libs[name], label, 6001,
                              *ctc.ctc_plan(6001))
    return runs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", help="checkouts of this repo")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--floor", action="store_true",
                    help="measure the recursion's dependent-step floor")
    ap.add_argument("--cut", action="store_true",
                    help="time both routes across the lanes route's cut")
    ap.add_argument("--ablate", action="store_true",
                    help="time variants of the lanes route")
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
