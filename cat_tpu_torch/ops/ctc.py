"""CTC loss as a log-semiring recursion over the blank-interleaved label
lattice (counterpart of `cat_tpu/ops/ctc.py`, its `lax.scan` path).

Variable lengths are handled by the JAX package's padding construction:
padded frames emit blank with log-prob 0 and every other state LOG_EPS,
which moves all path mass into the final blank state at no cost, so one
loop over the batch's T is exact for every utterance. The gradient is the
exact posterior from an alpha and a beta pass (d nll / d log_probs =
-gamma), in a `torch.autograd.Function`, not autograd through the loop.

The loop is plain PyTorch: a handful of (N, S) launches per frame, which
is host-launch-bound on the card. The TPU's Pallas alpha/beta kernels
(`cat_tpu/ops/ctc_pallas.py`) are queued in ROADMAP.md.
Labels use blank = 0 by convention.
"""
from __future__ import annotations

import torch

from cat_tpu_torch.ops.semiring import LOG_EPS, logaddexp3, safe_logaddexp


def _shift_right(x, k):
    """x[..., s-k] with LOG_EPS fill (along the last axis)."""
    return torch.nn.functional.pad(x[..., :-k], (k, 0), value=LOG_EPS)


def _shift_left(x, k):
    return torch.nn.functional.pad(x[..., k:], (0, k), value=LOG_EPS)


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


class _CTCNll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, labels, input_lengths, label_lengths, blank):
        lp = log_probs.float()
        N, T, V = lp.shape
        S = 2 * labels.shape[1] + 1
        ext, svalid, allow2 = _lattice_tables(labels, label_lengths, blank, S)
        em = _emissions(lp, ext, svalid, input_lengths, blank)
        alpha = torch.full((N, S), LOG_EPS, device=lp.device)
        alpha[:, 0] = 0.0
        alphas = torch.empty(T, N, S, device=lp.device)
        for t in range(T):
            a2 = torch.where(allow2, _shift_right(alpha, 2), LOG_EPS)
            alpha = torch.clamp_min(
                em[t] + logaddexp3(alpha, _shift_right(alpha, 1), a2),
                LOG_EPS)
            alphas[t] = alpha
        ll = _final_ll(alpha, label_lengths)
        ctx.save_for_backward(ext, allow2, em, alphas, ll, input_lengths,
                              label_lengths)
        ctx.vocab = V
        ctx.dtype = log_probs.dtype
        return -ll

    @staticmethod
    def backward(ctx, g):
        ext, allow2, em, alphas, ll, input_lengths, label_lengths = \
            ctx.saved_tensors
        T, N, S = em.shape
        dev = em.device
        s_idx = torch.arange(S, device=dev)
        idx1 = 2 * label_lengths
        idx2 = idx1 - 1
        final = (s_idx[None, :] == idx1[:, None]) | (
            (s_idx[None, :] == idx2[:, None]) & (idx2 >= 0)[:, None])
        beta = torch.where(final, 0.0, LOG_EPS)
        allow2_dst = _shift_left(torch.where(allow2, 0.0, LOG_EPS), 2) == 0.0
        betas = torch.empty_like(alphas)
        betas[T - 1] = beta
        for t in range(T - 2, -1, -1):
            b = torch.clamp_min(em[t + 1] + beta, LOG_EPS)
            b2 = torch.where(allow2_dst, _shift_left(b, 2), LOG_EPS)
            beta = torch.clamp_min(logaddexp3(b, _shift_left(b, 1), b2),
                                   LOG_EPS)
            betas[t] = beta
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
