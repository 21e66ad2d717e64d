"""RNN-Transducer loss as a log-semiring recursion over the (T, U+1)
lattice (counterpart of `cat_tpu/ops/rnnt.py`, its Pallas route).

Variable (T_n, U_n) are handled as the JAX package handles them: padded
frames emit blank for free, labels beyond U_n are impossible, so all path
mass rides the u = U_n row to the batch's last frame and the likelihood
is read at one place, alphas[T-1][n, U_n] + blank_eff[T-1][n, U_n]. The
gradient is the exact posterior from an alpha and a beta pass, in a
`torch.autograd.Function`, scattered into the (N, T, U+1, V) lattice at
the blank and label indices (no one-hot products).

The two recursions are `forward_alphas` and `backward_betas`, which
replace the TPU kernels `_alpha_kernel` and `_beta_kernel` of
`cat_tpu/ops/rnnt_pallas.py`: on a CUDA tensor each launches its kernel
in `cat_tpu_torch/csrc/rnnt.cu` (one launch for all frames, on the route
`rnnt_plan` picks from U+1) and counts it, on a CPU tensor it takes its
plain version (`forward_alphas_reference`, `backward_betas_reference`: a
loop over frames with a log-depth scan along u, as `_log_linrec` solves
each row). The tables and the posteriors are vectorised PyTorch, a few
launches per step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from cat_tpu_torch import _build
from cat_tpu_torch.ops.semiring import LOG_EPS, safe_logaddexp

# the row-scan kernels keep one row of U+1 f32 states, 32 warp totals twice
# and two carries in shared memory, at most 227 KB
MAX_U1 = 227 * 1024 // 4 - 130
# the wavefront kernels run one block of at most WAVE_MAX_WARPS warps an
# utterance, one state a thread, and load the tables WAVE_PREFETCH steps
# ahead (`WAVE_MAX_WARPS`, `PREFETCH` of `csrc/rnnt.cu`)
WAVE_MAX_WARPS = 32
WAVE_PREFETCH = 16
ROUTES = ("rowscan", "wavefront")  # the C entries' route codes 0 and 1


class RnntPlan(NamedTuple):
    route: str   # "wavefront" or "rowscan"
    warps: int   # wavefront: warps a block, ceil(U1 / 32); rowscan: 0


def rnnt_plan(U1: int) -> RnntPlan:
    """The route of both lattice kernels for U+1 = U1 states a frame: the
    wavefront (one block an utterance of W = ceil(U1 / 32) warps, one state
    a thread, one anti-diagonal a step) up to 32·WAVE_MAX_WARPS = 1024
    states, a block's most threads; the row scan (one block an utterance,
    one frame a step) above, up to MAX_U1. The cut is where the wavefront
    runs out of threads. On the training batch's frames
    (`tools/torch_rnnt_ab.py --cut`, PERF.md §6) the wavefront is the
    faster route at U+1 = 83 to 768 and about level at 1024 (alpha
    faster, beta slower), and from U+1 = 512 on only its states stay
    within the state gate of the exact values. `csrc/rnnt.cu` refuses
    any other plan."""
    if not 1 <= U1 <= MAX_U1:
        raise ValueError(f"rnnt_plan: the kernels take 1 <= U+1 <= {MAX_U1}, "
                         f"got {U1}")
    warps = -(-U1 // 32)
    if warps <= WAVE_MAX_WARPS:
        return RnntPlan("wavefront", warps)
    return RnntPlan("rowscan", 0)


def _label_index(labels):
    """(N, U+1) int64: the labels, then a 0 for the last row (unused)."""
    return F.pad(labels.long(), (0, 1))


def _row_tables(log_probs, labels, input_lengths, label_lengths, blank):
    """Blank and label transition log-probs with the padding semantics:
    (blank_eff, label_eff, blank_raw, label_raw), each (T, N, U+1) f32.
    blank_eff is 0 on padded frames (a free ride), else lp[n, t, u,
    blank]; label_eff is LOG_EPS for u >= U_n or on padded frames, else
    lp[n, t, u, y_{u+1}]."""
    N, T, U1, _ = log_probs.shape
    dev = log_probs.device
    blank_raw = log_probs[..., blank]
    idx = _label_index(labels)[:, None, :, None].expand(N, T, U1, 1)
    label_raw = torch.gather(log_probs, 3, idx)[..., 0]
    frame_valid = (torch.arange(T, device=dev)[None, :, None]
                   < input_lengths[:, None, None])
    u_valid = (torch.arange(U1, device=dev)[None, None, :]
               < label_lengths[:, None, None])
    blank_eff = torch.where(frame_valid, blank_raw, 0.0)
    label_eff = torch.where(frame_valid & u_valid, label_raw, LOG_EPS)
    tr = lambda x: x.transpose(0, 1).contiguous()
    return tr(blank_eff), tr(label_eff), tr(blank_raw), tr(label_raw)


def _final_ll(alphas, blank_eff, label_lengths):
    n_idx = torch.arange(alphas.shape[1], device=alphas.device)
    return (alphas[-1][n_idx, label_lengths]
            + blank_eff[-1][n_idx, label_lengths])


def beta_term(label_lengths, U1):
    """The termination row beta_T (N, U+1) f32: 0 at u = U_n, else
    LOG_EPS."""
    u = torch.arange(U1, device=label_lengths.device)
    return torch.where(u[None, :] == label_lengths[:, None], 0.0, LOG_EPS)


def _linrec(m, a):
    """Solve r[u] = a[u] ⊕ (m[u] ⊗ r[u-1]) along the last axis in the log
    semiring (m[0] must be LOG_EPS): a Hillis-Steele inclusive scan of
    (m, a) pairs, the identity (0, LOG_EPS) shifted in."""
    U = a.shape[-1]
    d = 1
    while d < U:
        pm = F.pad(m[..., :-d], (d, 0), value=0.0)
        pa = F.pad(a[..., :-d], (d, 0), value=LOG_EPS)
        a = safe_logaddexp(a, torch.clamp_min(m + pa, LOG_EPS))
        m = torch.clamp_min(m + pm, LOG_EPS)
        d *= 2
    return a


def forward_alphas_reference(blank_eff, label_eff):
    """Plain version of `forward_alphas`: a loop over frames, in the
    tables' dtype (float64 tables give an exact witness)."""
    T, N, U1 = blank_eff.shape
    alpha = torch.full((N, U1), LOG_EPS, dtype=blank_eff.dtype,
                       device=blank_eff.device)
    alpha[:, 0] = 0.0
    alphas = torch.empty_like(blank_eff)
    for t in range(T):
        base = alpha if t == 0 else torch.clamp_min(alpha + blank_eff[t - 1],
                                                    LOG_EPS)
        m = F.pad(label_eff[t, :, :-1], (1, 0), value=LOG_EPS)
        alpha = torch.clamp_min(_linrec(m, base), LOG_EPS)
        alphas[t] = alpha
    return alphas


def backward_betas_reference(blank_eff, label_eff, beta_term):
    """Plain version of `backward_betas`: a loop over frames, the suffix
    scan as a prefix scan of the flipped row, in the tables' dtype."""
    T = blank_eff.shape[0]
    betas = torch.empty_like(blank_eff)
    beta = beta_term.to(blank_eff.dtype)
    for t in range(T - 1, -1, -1):
        base = torch.clamp_min(blank_eff[t] + beta, LOG_EPS)
        m = F.pad(label_eff[t, :, :-1], (0, 1), value=LOG_EPS)
        beta = torch.clamp_min(_linrec(m.flip(-1), base.flip(-1)).flip(-1),
                               LOG_EPS)
        betas[t] = beta
    return betas


def _check(name, tables, rows):
    """(T, N, U+1) of the tables; raises unless every table is a contiguous
    f32 (T, N, U+1) tensor and every row a contiguous f32 (N, U+1) tensor,
    all on one CUDA device, with U+1 <= MAX_U1."""
    t0 = tables[0]
    ok = t0.dim() == 3 and t0.is_cuda
    shape = tuple(t0.shape) if ok else (0, 0, 0)
    for t, want in [(t, shape) for t in tables] + [(r, shape[1:])
                                                   for r in rows]:
        ok = ok and t.dtype == torch.float32 and t.is_contiguous() \
            and tuple(t.shape) == want and t.device == t0.device
    if not ok:
        got = [(t.dtype, tuple(t.shape), str(t.device))
               for t in (*tables, *rows)]
        raise ValueError(f"{name}: the kernel takes contiguous f32 tables "
                         f"(T, N, U+1) and (N, U+1) rows on one CUDA device, "
                         f"got {got}")
    if shape[2] > MAX_U1:
        raise ValueError(f"{name}: the kernel takes U+1 <= {MAX_U1} (one "
                         f"row in shared memory), got {shape[2]}")
    return shape


def _launch(entry, ptrs, shape, plan, device):
    """Call the C entry `entry` of `csrc/rnnt.cu` on the pointers `ptrs`
    and the (T, N, U+1) of the tables with `plan`; raises if the kernel
    refuses or fails to launch."""
    err = getattr(_build.load("rnnt", _ENTRIES), entry)(
        *ptrs, *shape, ROUTES.index(plan.route), plan.warps,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, entry)


def forward_alphas(blank_eff, label_eff):
    """All alpha rows (T, N, U+1) f32 of the tables blank_eff and label_eff
    (T, N, U+1) f32. A CPU tensor takes `forward_alphas_reference`; a CUDA
    tensor launches `rnnt_alpha` of `csrc/rnnt.cu` on the route of
    `rnnt_plan` or raises."""
    if blank_eff.device.type == "cpu":
        return forward_alphas_reference(blank_eff, label_eff)
    shape = _check("forward_alphas", (blank_eff, label_eff), ())
    out = torch.empty_like(blank_eff)
    _launch("rnnt_alpha", (blank_eff.data_ptr(), label_eff.data_ptr(),
                           out.data_ptr()), shape, rnnt_plan(shape[2]),
            out.device)
    forward_alphas.launches += 1
    return out


def backward_betas(blank_eff, label_eff, beta_term):
    """All beta rows (T, N, U+1) f32, beta[t] from beta[t+1] (beta_term
    (N, U+1) f32 for t = T-1) and the tables of frame t. A CPU tensor takes
    `backward_betas_reference`; a CUDA tensor launches `rnnt_beta` of
    `csrc/rnnt.cu` on the route of `rnnt_plan` or raises."""
    if blank_eff.device.type == "cpu":
        return backward_betas_reference(blank_eff, label_eff, beta_term)
    shape = _check("backward_betas", (blank_eff, label_eff), (beta_term,))
    out = torch.empty_like(blank_eff)
    _launch("rnnt_beta", (blank_eff.data_ptr(), label_eff.data_ptr(),
                          beta_term.data_ptr(), out.data_ptr()), shape,
            rnnt_plan(shape[2]), out.device)
    backward_betas.launches += 1
    return out


def chain_floor(out, steps, weight=-0.5):
    """Measurement only, for the recursions' bound: launches `steps`
    dependent steps of the wavefront (one f64 `lae_wide` of two floored
    sums, its floor and one shuffle) with no loads on out.shape[0] blocks
    of one warp; out (N, 32) f32 on the card takes the last states."""
    if not (out.is_cuda and out.dtype == torch.float32
            and out.is_contiguous() and out.shape[1:] == (32,)):
        raise ValueError("chain_floor: out is a contiguous f32 (N, 32) CUDA "
                         "tensor")
    err = _build.load("rnnt", _ENTRIES).rnnt_chain_floor(
        out.data_ptr(), out.shape[0], int(steps), float(weight),
        torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "rnnt_chain_floor")


_ENTRIES = {"rnnt_alpha": (3, 5, 0), "rnnt_beta": (4, 5, 0),
            "rnnt_chain_floor": (1, 2, 1)}
forward_alphas.launches = 0
backward_betas.launches = 0


def posteriors(blank_eff, label_eff, blank_raw, label_raw, alphas, ll,
               input_lengths, label_lengths, g):
    """The blank and label posteriors times the cotangent g (N,), each
    (N, T, U+1) f32, from a beta pass over the tables: exp(alpha + lp +
    beta_next - ll) on valid frames and lattice nodes, 0 where the score
    is at or below LOG_EPS / 2."""
    T, N, U1 = blank_eff.shape
    dev = blank_eff.device
    term = beta_term(label_lengths, U1)
    betas = backward_betas(blank_eff, label_eff, term)
    betas_next = torch.cat([betas[1:], term[None]], 0)
    ll_safe = torch.where(ll <= LOG_EPS / 2, 0.0, ll)[None, :, None]
    frame_valid = (torch.arange(T, device=dev)[:, None, None]
                   < input_lengths[None, :, None])
    u_idx = torch.arange(U1, device=dev)[None, None, :]
    sb = alphas + blank_raw + betas_next - ll_safe
    pos_blank = torch.where(
        frame_valid & (u_idx <= label_lengths[None, :, None])
        & (sb > LOG_EPS / 2), torch.exp(sb), 0.0)
    beta_up = F.pad(betas[:, :, 1:], (0, 1), value=LOG_EPS)
    sl = alphas + label_raw + beta_up - ll_safe
    pos_label = torch.where(
        frame_valid & (u_idx < label_lengths[None, :, None])
        & (sl > LOG_EPS / 2), torch.exp(sl), 0.0)
    gw = g.float()[None, :, None]
    return ((pos_blank * gw).transpose(0, 1),
            (pos_label * gw).transpose(0, 1))


class _RNNTNll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, labels, input_lengths, label_lengths, blank):
        lp = log_probs.float()
        tables = _row_tables(lp, labels, input_lengths, label_lengths, blank)
        alphas = forward_alphas(tables[0], tables[1])
        ll = _final_ll(alphas, tables[0], label_lengths)
        ctx.save_for_backward(*tables, alphas, ll, labels, input_lengths,
                              label_lengths)
        ctx.blank, ctx.vocab = blank, lp.shape[-1]
        ctx.dtype = log_probs.dtype
        return -ll

    @staticmethod
    def backward(ctx, g):
        (blank_eff, label_eff, blank_raw, label_raw, alphas, ll, labels,
         input_lengths, label_lengths) = ctx.saved_tensors
        T, N, U1 = blank_eff.shape
        pos_blank, pos_label = posteriors(
            blank_eff, label_eff, blank_raw, label_raw, alphas, ll,
            input_lengths, label_lengths, g)
        grad = torch.zeros(N, T, U1, ctx.vocab, device=blank_eff.device)
        grad[..., ctx.blank] = -pos_blank
        idx = _label_index(labels)[:, None, :, None].expand(N, T, U1, 1)
        grad.scatter_add_(3, idx, -pos_label[..., None])
        return grad.to(ctx.dtype), None, None, None, None


def _reduce(nll, reduction):
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return nll.mean()
    raise ValueError(f"bad reduction {reduction}")


def rnnt_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
              reduction="mean"):
    """RNN-T negative log-likelihood.

    log_probs (N, T, U+1, V) joiner outputs after log_softmax; labels
    (N, U) ints, 0-padded (blank never a label); input_lengths,
    label_lengths (N,) ints on the device of log_probs. reduction: 'none'
    | 'sum' | 'mean' (over the batch). Differentiable in log_probs."""
    nll = _RNNTNll.apply(log_probs, labels.long(), input_lengths.long(),
                         label_lengths.long(), int(blank))
    return _reduce(nll, reduction)
