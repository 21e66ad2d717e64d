"""CTC loss as a log-semiring recursion over the blank-interleaved label
lattice (counterpart of `cat_tpu/ops/ctc.py`, its Pallas route).

Variable lengths are handled by the JAX package's padding construction:
padded frames emit blank with log-prob 0 and every other state LOG_EPS,
which moves all path mass into the final blank state at no cost, so one
recursion over the batch's T is exact for every utterance. The gradient
is the exact posterior from an alpha and a beta pass (d nll / d log_probs
= -gamma), in a `torch.autograd.Function`, not autograd through the loop.

The two recursions are `forward_alphas` and `backward_betas`, which
replace the TPU kernels `_alpha_kernel` and `_beta_kernel` of
`cat_tpu/ops/ctc_pallas.py`: on a CUDA tensor each launches its kernel in
`cat_tpu_torch/csrc/ctc.cu` (one launch for all frames, on the route
`ctc_plan` picks from S) and counts it, on a CPU tensor it takes its plain
version (`forward_alphas_reference`,
`backward_betas_reference`: a loop over frames). The lattice tables, the
emission table and the gamma/scatter-add gradient are vectorised PyTorch,
a few launches per step. Labels use blank = 0 by convention.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from cat_tpu_torch import _build
from cat_tpu_torch.ops.semiring import LOG_EPS, logaddexp3, safe_logaddexp

# the frames kernels keep two rows of S f32 states and S skip bytes in
# shared memory, at most 227 KB
MAX_S = 227 * 1024 // 9
# the lanes kernels run one block of at most LANES_MAX_WARPS warps an
# utterance, one state a thread, and load the emissions LANES_PREFETCH
# frames ahead (`LANES_MAX_WARPS`, `PREFETCH` of `csrc/ctc.cu`)
LANES_MAX_WARPS = 32
LANES_PREFETCH = 16
ROUTES = ("frames", "lanes")  # the C entries' route codes 0 and 1


class CtcPlan(NamedTuple):
    route: str   # "lanes" or "frames"
    warps: int   # lanes: warps a block, ceil(S / 32); frames: 0


def ctc_plan(S: int) -> CtcPlan:
    """The route of both lattice kernels for S = 2U + 1 states a frame:
    lanes (one block an utterance of W = ceil(S / 32) warps, state s in
    thread s, the neighbours by shuffles and across the warps' seams) up
    to 32·LANES_MAX_WARPS = 1024 states, a block's most threads; frames
    (one block an utterance, the states of a frame in shared memory) above,
    up to MAX_S. `csrc/ctc.cu` refuses any other plan."""
    if not 1 <= S <= MAX_S:
        raise ValueError(f"ctc_plan: the kernels take 1 <= S <= {MAX_S} "
                         f"lattice states, got S = {S}")
    warps = -(-S // 32)
    if warps <= LANES_MAX_WARPS:
        return CtcPlan("lanes", warps)
    return CtcPlan("frames", 0)


def _shift_right(x, k):
    """x[..., s-k] with LOG_EPS fill (along the last axis; any width)."""
    return torch.nn.functional.pad(x, (k, 0), value=LOG_EPS)[
        ..., :x.shape[-1]]


def _shift_left(x, k):
    return torch.nn.functional.pad(x, (0, k), value=LOG_EPS)[..., k:]


def _lattice_tables(labels, label_lengths, blank, S):
    """ext (N, S): ext[2i] = blank, ext[2i+1] = labels[i]; svalid (N, S):
    state < 2 U_n + 1; allow2 (N, S): the skip s-2 -> s is permitted."""
    N = labels.shape[0]
    s_idx = torch.arange(S, device=labels.device)
    ext = torch.full((N, S), blank, dtype=torch.int64, device=labels.device)
    ext[:, 1::2] = labels.long()
    svalid = s_idx[None, :] < (2 * label_lengths[:, None] + 1)
    is_odd = (s_idx % 2 == 1) & (s_idx >= 3)
    allow2 = is_odd[None, :] & (ext != torch.roll(ext, 2, dims=1))
    return ext, svalid, allow2


def _emissions(log_probs, ext, svalid, input_lengths, blank):
    """Per-state emissions (T, N, S), padding-aware (see the module doc)."""
    N, T, V = log_probs.shape
    S = ext.shape[1]
    em = torch.gather(log_probs, 2, ext[:, None, :].expand(N, T, S))
    pad_em = torch.where(ext == blank, 0.0, LOG_EPS)[:, None, :]
    t_idx = torch.arange(T, device=log_probs.device)
    frame_valid = t_idx[None, :, None] < input_lengths[:, None, None]
    em = torch.where(frame_valid, em, pad_em)
    em = torch.where(svalid[:, None, :], em, LOG_EPS)
    return em.transpose(0, 1).contiguous()


def _final_ll(alpha_last, label_lengths):
    n_idx = torch.arange(alpha_last.shape[0], device=alpha_last.device)
    idx1 = 2 * label_lengths
    idx2 = idx1 - 1
    a1 = alpha_last[n_idx, idx1]
    a2 = torch.where(idx2 >= 0, alpha_last[n_idx, idx2.clamp_min(0)],
                     LOG_EPS)
    return safe_logaddexp(a1, a2)


def _beta_tables(allow2, label_lengths):
    """allow2_dst (N, S): the skip s -> s+2 is permitted; beta_last (N, S):
    0 on the final states (the last blank and the last label), LOG_EPS
    elsewhere."""
    S = allow2.shape[1]
    s_idx = torch.arange(S, device=allow2.device)
    idx1 = 2 * label_lengths
    idx2 = idx1 - 1
    final = (s_idx[None, :] == idx1[:, None]) | (
        (s_idx[None, :] == idx2[:, None]) & (idx2 >= 0)[:, None])
    beta_last = torch.where(final, 0.0, LOG_EPS)
    allow2_dst = _shift_left(torch.where(allow2, 0.0, LOG_EPS), 2) == 0.0
    return allow2_dst, beta_last


def forward_alphas_reference(em, allow2):
    """Plain version of `forward_alphas`: a loop over frames."""
    T, N, S = em.shape
    alpha = torch.full((N, S), LOG_EPS, device=em.device)
    alpha[:, 0] = 0.0
    alphas = torch.empty(T, N, S, device=em.device)
    for t in range(T):
        a2 = torch.where(allow2, _shift_right(alpha, 2), LOG_EPS)
        alpha = torch.clamp_min(
            em[t] + logaddexp3(alpha, _shift_right(alpha, 1), a2), LOG_EPS)
        alphas[t] = alpha
    return alphas


def backward_betas_reference(em, allow2_dst, beta_last):
    """Plain version of `backward_betas`: a loop over frames."""
    T = em.shape[0]
    betas = torch.empty_like(em)
    beta = beta_last
    betas[T - 1] = beta
    for t in range(T - 2, -1, -1):
        b = torch.clamp_min(em[t + 1] + beta, LOG_EPS)
        b2 = torch.where(allow2_dst, _shift_left(b, 2), LOG_EPS)
        beta = torch.clamp_min(logaddexp3(b, _shift_left(b, 1), b2), LOG_EPS)
        betas[t] = beta
    return betas


def _check(name, em, masks, rows):
    """(T, N, S) of em; raises unless em is contiguous (T, N, S) f32 and
    each mask (bool) and row (f32) is contiguous (N, S) on em's device."""
    ok = em.dim() == 3 and em.dtype == torch.float32 and em.is_contiguous()
    T, N, S = em.shape if ok else (0, 0, 0)
    for t, dt in [(m, torch.bool) for m in masks] + [(r, torch.float32)
                                                     for r in rows]:
        ok = ok and t.dtype == dt and t.is_contiguous() \
            and tuple(t.shape) == (N, S) and t.device == em.device
    if not ok:
        raise ValueError(f"{name}: the kernel takes contiguous f32 em (T, N, "
                         f"S) and (N, S) bool masks / f32 rows on one CUDA "
                         f"device, got em {em.dtype} {tuple(em.shape)}")
    return T, N, S


def _launch(entry, ptrs, shape, device):
    """Call the C entry `entry` of `csrc/ctc.cu` on the pointers `ptrs` and
    the (T, N, S) of the emission table, on the route of `ctc_plan`;
    raises if the kernel refuses or fails to launch."""
    plan = ctc_plan(shape[2])
    err = getattr(_build.load("ctc", _ENTRIES), entry)(
        *ptrs, *shape, ROUTES.index(plan.route), plan.warps,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, entry)


def forward_alphas(em, allow2):
    """All alpha rows (T, N, S) f32 of the emission table em (T, N, S) f32
    and the skip permissions allow2 (N, S) bool. A CPU tensor takes
    `forward_alphas_reference`; a CUDA tensor launches `ctc_alpha` of
    `csrc/ctc.cu` on the route of `ctc_plan` or raises."""
    if em.device.type == "cpu":
        return forward_alphas_reference(em, allow2)
    shape = _check("forward_alphas", em, (allow2,), ())
    out = torch.empty_like(em)
    _launch("ctc_alpha", (em.data_ptr(), allow2.data_ptr(), out.data_ptr()),
            shape, em.device)
    forward_alphas.launches += 1
    return out


def backward_betas(em, allow2_dst, beta_last):
    """All beta rows (T, N, S) f32: beta[T-1] = beta_last (N, S) f32, and
    beta[t] from beta[t+1] and em[t+1] with the skip permissions
    allow2_dst (N, S) bool. A CPU tensor takes `backward_betas_reference`;
    a CUDA tensor launches `ctc_beta` of `csrc/ctc.cu` on the route of
    `ctc_plan` or raises."""
    if em.device.type == "cpu":
        return backward_betas_reference(em, allow2_dst, beta_last)
    shape = _check("backward_betas", em, (allow2_dst,), (beta_last,))
    out = torch.empty_like(em)
    _launch("ctc_beta", (em.data_ptr(), allow2_dst.data_ptr(),
                         beta_last.data_ptr(), out.data_ptr()), shape,
            em.device)
    backward_betas.launches += 1
    return out


def chain_floor(out, steps, weight=-0.5):
    """Measurement only, for the recursions' bound: launches `steps`
    dependent steps of the recursion (`lae3` of a state and its two
    neighbours, two shuffles, an added weight and its floor) with no loads
    on out.shape[0] blocks of one warp; out (N, 32) f32 on the card takes
    the last states."""
    if not (out.is_cuda and out.dtype == torch.float32
            and out.is_contiguous() and out.shape[1:] == (32,)):
        raise ValueError("chain_floor: out is a contiguous f32 (N, 32) CUDA "
                         "tensor")
    err = _build.load("ctc", _ENTRIES).ctc_chain_floor(
        out.data_ptr(), out.shape[0], int(steps), float(weight),
        torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "ctc_chain_floor")


_ENTRIES = {"ctc_alpha": (3, 5, 0), "ctc_beta": (4, 5, 0),
            "ctc_chain_floor": (1, 2, 1)}
forward_alphas.launches = 0
backward_betas.launches = 0


class _CTCNll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, labels, input_lengths, label_lengths, blank):
        lp = log_probs.float()
        S = 2 * labels.shape[1] + 1
        ext, svalid, allow2 = _lattice_tables(labels, label_lengths, blank, S)
        em = _emissions(lp, ext, svalid, input_lengths, blank)
        alphas = forward_alphas(em, allow2)
        ll = _final_ll(alphas[-1], label_lengths)
        ctx.save_for_backward(ext, allow2, em, alphas, ll, input_lengths,
                              label_lengths)
        ctx.vocab = lp.shape[-1]
        ctx.dtype = log_probs.dtype
        return -ll

    @staticmethod
    def backward(ctx, g):
        ext, allow2, em, alphas, ll, input_lengths, label_lengths = \
            ctx.saved_tensors
        T, N, S = em.shape
        dev = em.device
        betas = backward_betas(em, *_beta_tables(allow2, label_lengths))
        ll_safe = torch.where(ll <= LOG_EPS / 2, 0.0, ll)
        score = alphas + betas - ll_safe[None, :, None]
        gamma = torch.where(score <= LOG_EPS / 2, 0.0, torch.exp(score))
        frame_valid = (torch.arange(T, device=dev)[:, None]
                       < input_lengths[None, :])
        gamma = gamma * frame_valid[:, :, None] * g.float()[None, :, None]
        grad = torch.zeros(N, T, ctx.vocab, device=dev)
        grad.scatter_add_(2, ext[:, None, :].expand(N, T, S),
                          -gamma.transpose(0, 1))
        return grad.to(ctx.dtype), None, None, None, None


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean"):
    """CTC negative log-likelihood.

    log_probs (N, T, V) log-softmax outputs; labels (N, U) ints, 0-padded
    (blank never a label); input_lengths, label_lengths (N,) ints on the
    device of log_probs. reduction: 'none' | 'sum' | 'mean' (over the
    batch). Differentiable in log_probs."""
    nll = _CTCNll.apply(log_probs, labels.long(), input_lengths.long(),
                        label_lengths.long(), int(blank))
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return nll.mean()
    raise ValueError(f"bad reduction {reduction}")
