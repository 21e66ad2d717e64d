"""Dense CTC-CRF denominator for n-gram LMs of order <= 3 (counterpart of
`cat_tpu/ops/crf_dense.py`, its XLA scan path).

The backoff n-gram denominator LM is expanded on the host into a dense
context-transition tensor W[a, b, u] = log P(u | a, b) (V, V, V), index 0
= BOS, and the composed state space factorises as {in-phone, post-blank}
x (context a, b): two (N, V, V) alpha tensors. Per frame (y = frame
log-probs, blank = 0):
  stay:   a_in[a,b] + y[b]                 -> a_in[a,b]
  blank:  (a_in + a_bl)[a,b] + y[0]        -> a_bl[a,b]
  emit u: (a_bl[a,c] + a_in[a,c]|u!=c) + W[a,c,u] + y[u] -> a_in[c,u]
(+ is log-add). logZ = LSE over both tensors of alpha + F, F[a,b] =
log P(EOS | a, b). The emission contraction over `a` runs in the exp
domain as a batched matrix product with a per-(n, b) max shift.

`dense_den_log_partition` is a `torch.autograd.Function`: the forward
keeps alpha snapshots every K = 24 frames, the backward recomputes each
segment's alphas from its snapshot and runs the beta recursion over it,
emitting the exact posterior gradient row by row. The recursions are
plain PyTorch loops over frames, host-launch-bound on the card; the
TPU's fused forward kernel (`cat_tpu/ops/crf_dense_pallas.py`) and this
backward as a kernel are queued in ROADMAP.md.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from cat_tpu_torch.ops.ctc import ctc_loss
from cat_tpu_torch.ops.semiring import LOG_EPS

LN10 = math.log(10.0)


class DenseDen:
    """Host-expanded dense denominator tables. V includes blank at 0;
    context symbol 0 doubles as BOS (blank never appears in contexts)."""

    def __init__(self, logw, final, ckpt_every=24):
        # logw (V, V, V) f32: log P(u | a, b), LOG_EPS for u == 0 (blank
        # is not an LM event); final (V, V) f32; ckpt_every: frames per
        # alpha snapshot (memory O(T/K + K) alpha tensors, not O(T))
        self.logw = np.asarray(logw, np.float32)
        self.final = np.asarray(final, np.float32)
        self.num_classes = int(self.logw.shape[0])
        self.ckpt_every = int(ckpt_every)
        self._tables = {}

    @classmethod
    def from_ngram(cls, lm, num_classes):
        """Expand a (<= 3)-gram NGramLM over phone ids 1..V-1: per-context
        rows are the backoff weight plus the parent row, overwritten by the
        explicit n-gram entries."""
        V = num_classes
        EOSs = "</s>"
        syms = ["<s>" if i == 0 else i for i in range(V)]
        NEG = LOG_EPS / LN10  # in log10

        # unigram row over events u in 1..V-1 plus EOS at column V
        uni = np.full((V + 1,), NEG, np.float64)
        for u in range(1, V):
            p = lm.probs[1].get((u,))
            if p is not None:
                uni[u] = p
        pe = lm.probs[1].get((EOSs,))
        if pe is not None:
            uni[V] = pe

        def expand(ctx, parent_row):
            k = len(ctx)
            bow = lm.bows[k].get(ctx, 0.0) if k < len(lm.bows) else 0.0
            row = parent_row + bow
            probs_k1 = lm.probs[k + 1]
            for u in range(1, V):
                p = probs_k1.get(ctx + (u,))
                if p is not None:
                    row[u] = p
            pe = probs_k1.get(ctx + (EOSs,))
            if pe is not None:
                row[V] = pe
            return row

        logw = np.full((V, V, V), LOG_EPS, np.float32)
        final = np.full((V, V), LOG_EPS, np.float32)
        if lm.order == 1:
            row = uni * LN10
            logw[:, :, 1:] = row[1:V].astype(np.float32)
            final[:, :] = np.float32(row[V])
            return cls(logw, final)
        bi_rows = {b: expand((syms[b],), uni.copy()) for b in range(V)}
        if lm.order == 2:
            for b in range(V):
                row = bi_rows[b] * LN10
                logw[:, b, 1:] = row[1:V].astype(np.float32)
                final[:, b] = np.float32(row[V])
            return cls(logw, final)
        if lm.order > 3:
            raise NotImplementedError("the dense denominator takes n-gram "
                                      "orders up to 3")
        # trigram rows per (a, b); contexts (x, BOS) with x != BOS are
        # unreachable and stay LOG_EPS
        for a in range(V):
            for b in range(V):
                if b == 0 and a != 0:
                    continue
                row = expand((syms[a], syms[b]), bi_rows[b].copy()) * LN10
                logw[a, b, 1:] = row[1:V].astype(np.float32)
                final[a, b] = np.float32(row[V])
        return cls(logw, final)

    def device_tables(self, device=None):
        """(exp(W) (V, V, V), F (V, V)) f32 on `device`, made once per
        device."""
        key = str(torch.device(device or "cpu"))
        if key not in self._tables:
            logw = torch.from_numpy(self.logw).to(device)
            self._tables[key] = (torch.exp(torch.clamp_min(logw, LOG_EPS)),
                                 torch.from_numpy(self.final).to(device))
        return self._tables[key]

    def save(self, path):
        np.savez(path, logw=self.logw, final=self.final)

    @classmethod
    def load(cls, path):
        z = np.load(path)
        return cls(z["logw"], z["final"])


def _lse_pair(a, b):
    m = torch.maximum(a, b)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m))
    return out.masked_fill(m <= LOG_EPS / 2, LOG_EPS)


def _emit_contract(src, expw):
    """T[n, b, u] = LSE_a(src[n, a, b] + W[a, b, u])."""
    m = torch.clamp_min(src.amax(dim=1), LOG_EPS)            # (M, b)
    p = torch.exp(src - m[:, None, :])                       # (M, a, b)
    s = torch.bmm(p.permute(2, 0, 1), expw.permute(1, 0, 2))  # (b, M, u)
    s = s.permute(1, 0, 2)
    out = m[:, :, None] + torch.log(torch.clamp_min(s, 1e-37))
    return out.masked_fill(s <= 0.0, LOG_EPS)


def _beta_contract(rhs, expw):
    """E[n, a, b] = LSE_u(rhs[n, b, u] + W[a, b, u])."""
    m = torch.clamp_min(rhs.amax(dim=2), LOG_EPS)            # (M, b)
    p = torch.exp(rhs - m[:, :, None])                       # (M, b, u)
    s = torch.bmm(p.permute(1, 0, 2), expw.permute(1, 2, 0))  # (b, M, a)
    s = s.permute(1, 2, 0)                                   # (M, a, b)
    out = m[:, None, :] + torch.log(torch.clamp_min(s, 1e-37))
    return out.masked_fill(s <= 0.0, LOG_EPS)


def _alpha_step(expw, eye, keep, a_in, a_bl, y_t):
    """One frame of the alpha recursion; also returns the emission term
    (before + y) that the backward's gradient row reuses."""
    N = a_in.shape[0]
    both = _emit_contract(torch.cat([a_bl, a_in], dim=0), expw)
    emit0 = _lse_pair(both[:N], both[N:].masked_fill(eye, LOG_EPS))
    new_in = torch.clamp_min(_lse_pair(a_in + y_t[:, None, :],
                                       emit0 + y_t[:, None, :]), LOG_EPS)
    new_bl = torch.clamp_min(_lse_pair(a_in, a_bl)
                             + y_t[:, 0, None, None], LOG_EPS)
    k = keep[:, None, None]
    return torch.where(k, new_in, a_in), torch.where(k, new_bl, a_bl), emit0


def _posterior(score):
    return torch.where(score <= LOG_EPS / 2, 0.0, torch.exp(score))


class _DenLogPartition(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, input_lengths, den):
        lp = log_probs.float()
        N, T, V = lp.shape
        expw, final = den.device_tables(lp.device)
        K = den.ckpt_every
        y = lp.transpose(0, 1)                                  # (T, N, V)
        eye = torch.eye(V, dtype=torch.bool, device=lp.device)
        a_in = torch.full((N, V, V), LOG_EPS, device=lp.device)
        a_bl = a_in.clone()
        a_bl[:, 0, 0] = 0.0
        t_idx = torch.arange(T, device=lp.device)
        keep = t_idx[:, None] < input_lengths[None, :]          # (T, N)
        snaps = []
        for t in range(T):
            if t % K == 0:
                snaps.append((a_in, a_bl))
            a_in, a_bl, _ = _alpha_step(expw, eye, keep[t], a_in, a_bl, y[t])

        def lse_all(x):
            m = torch.clamp_min(x.amax(dim=(1, 2)), LOG_EPS)
            s = torch.exp(x - m[:, None, None]).sum((1, 2))
            out = m + torch.log(torch.clamp_min(s, 1e-37))
            return out.masked_fill(s <= 0, LOG_EPS)

        logz = _lse_pair(lse_all(a_in + final), lse_all(a_bl + final))
        ctx.save_for_backward(lp, input_lengths, logz,
                              *[s for pair in snaps for s in pair])
        ctx.den = den
        ctx.dtype = log_probs.dtype
        return logz

    @staticmethod
    def backward(ctx, g):
        lp, input_lengths, logz, *flat = ctx.saved_tensors
        snaps = list(zip(flat[0::2], flat[1::2]))
        den = ctx.den
        N, T, V = lp.shape
        expw, final = den.device_tables(lp.device)
        K = den.ckpt_every
        y = lp.transpose(0, 1)
        eye = torch.eye(V, dtype=torch.bool, device=lp.device)
        keep = (torch.arange(T, device=lp.device)[:, None]
                < input_lengths[None, :])
        lz = torch.where(logz <= LOG_EPS / 2, 0.0, logz)[:, None, None]
        b_in = final[None].expand(N, V, V)
        b_bl = b_in
        grad = torch.empty(T, N, V, device=lp.device)
        for seg in range(len(snaps) - 1, -1, -1):
            t0, t1 = seg * K, min((seg + 1) * K, T)
            a_in, a_bl = snaps[seg]
            pre = []
            for t in range(t0, t1):  # the segment's pre-update alphas
                n_in, n_bl, emit0 = _alpha_step(expw, eye, keep[t], a_in,
                                                a_bl, y[t])
                pre.append((a_in, a_bl, emit0))
                a_in, a_bl = n_in, n_bl
            for t in range(t1 - 1, t0 - 1, -1):
                a_in, a_bl, emit0 = pre[t - t0]
                y_t = y[t]
                active = keep[t][:, None, None]
                # the gradient row for frame t, from the betas after it
                yu = y_t[:, None, :]
                g_stay = _posterior(a_in + yu + b_in - lz).sum(1)
                g_emit = _posterior(emit0 + yu + b_in - lz).sum(1)
                blank = y_t[:, 0, None, None]
                g_blank = _posterior(_lse_pair(a_in, a_bl) + blank + b_bl
                                     - lz).sum((1, 2))
                row = g_stay + g_emit
                row[:, 0] = g_blank
                grad[t] = torch.where(active[:, :, 0], row, 0.0)
                # betas before frame t
                rhs = yu + b_in
                both = _beta_contract(
                    torch.cat([rhs, rhs.masked_fill(eye, LOG_EPS)], dim=0),
                    expw)
                blank_term = blank + b_bl
                new_in = torch.clamp_min(
                    _lse_pair(_lse_pair(rhs, both[N:]), blank_term), LOG_EPS)
                new_bl = torch.clamp_min(_lse_pair(both[:N], blank_term),
                                         LOG_EPS)
                b_in = torch.where(active, new_in, b_in)
                b_bl = torch.where(active, new_bl, b_bl)
        grad = grad.transpose(0, 1) * g.float()[:, None, None]
        return grad.to(ctx.dtype), None, None


def dense_den_log_partition(log_probs, input_lengths, den: DenseDen):
    """(N,) log-partition of the dense n-gram denominator; log_probs
    (N, T, V), input_lengths (N,) on the same device. Differentiable in
    log_probs."""
    return _DenLogPartition.apply(log_probs, input_lengths.long(), den)


def ctc_crf_loss_dense(log_probs, labels, input_lengths, label_lengths,
                       den: DenseDen, lamb=0.1, blank=0, reduction="mean"):
    """CTC-CRF loss with the dense denominator:
    cost = logZ_den - (1 + lamb) * log p_ctc (per sequence)."""
    nll_ctc = ctc_loss(log_probs, labels, input_lengths, label_lengths,
                       blank=blank, reduction="none")
    logz = dense_den_log_partition(log_probs, input_lengths, den)
    per_seq = logz + (1.0 + lamb) * nll_ctc
    if reduction == "none":
        return per_seq
    if reduction == "sum":
        return per_seq.sum()
    if reduction == "mean":
        return per_seq.mean()
    raise ValueError(f"bad reduction {reduction}")
