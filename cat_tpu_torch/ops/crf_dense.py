"""Dense CTC-CRF denominator for n-gram LMs of order <= 3 (counterpart of
`cat_tpu/ops/crf_dense.py`, its fused-forward route).

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
domain with a per-(n, b) max shift; alphas stay in the log domain.

`dense_den_log_partition` is a `torch.autograd.Function` over two
passes. `den_forward` keeps alpha snapshots every K = 24 frames, the
layout of `dense_den_forward_pallas`, whose TPU kernel `_den_fwd_kernel`
it replaces; `den_backward` recomputes each segment's alphas from its
snapshot and runs the beta recursion over it, emitting the exact
posterior gradient row by row (the XLA `_den_bwd` of the JAX package). On
a CUDA tensor each launches its kernel in `cat_tpu_torch/csrc/crf_dense.cu`
(one launch for all frames, on thread-block clusters laid out by
`den_plan`) and counts it; on a CPU tensor each takes its
plain version (`den_forward_reference`, `den_backward_reference`: loops
over frames).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from cat_tpu_torch import _build
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
        device (`_tables` also keeps the card's cluster counts)."""
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


def _lse_all(x):
    """LSE over each utterance's (V, V) states."""
    m = torch.clamp_min(x.amax(dim=(1, 2)), LOG_EPS)
    s = torch.exp(x - m[:, None, None]).sum((1, 2))
    out = m + torch.log(torch.clamp_min(s, 1e-37))
    return out.masked_fill(s <= 0, LOG_EPS)


def den_forward_reference(log_probs, input_lengths, den):
    """Plain version of `den_forward`: a loop over frames."""
    N, T, V = log_probs.shape
    dev = log_probs.device
    expw, final = den.device_tables(dev)
    K = den.ckpt_every
    y = log_probs.transpose(0, 1)                               # (T, N, V)
    eye = torch.eye(V, dtype=torch.bool, device=dev)
    a_in = torch.full((N, V, V), LOG_EPS, device=dev)
    a_bl = a_in.clone()
    a_bl[:, 0, 0] = 0.0
    keep = torch.arange(T, device=dev)[:, None] < input_lengths[None, :]
    S = -(-T // K)
    snap_in = torch.empty(S, N, V, V, device=dev)
    snap_bl = torch.empty(S, N, V, V, device=dev)
    for t in range(T):
        if t % K == 0:
            snap_in[t // K], snap_bl[t // K] = a_in, a_bl
        a_in, a_bl, _ = _alpha_step(expw, eye, keep[t], a_in, a_bl, y[t])
    logz = _lse_pair(_lse_all(a_in + final), _lse_all(a_bl + final))
    return (snap_in, snap_bl), logz


def den_backward_reference(log_probs, input_lengths, snaps, logz, g, den):
    """Plain version of `den_backward`: per segment, in reverse, the
    recompute from its snapshot, then the beta recursion and the
    gradient rows frame by frame."""
    snap_in, snap_bl = snaps
    N, T, V = log_probs.shape
    dev = log_probs.device
    expw, final = den.device_tables(dev)
    K = den.ckpt_every
    y = log_probs.transpose(0, 1)
    eye = torch.eye(V, dtype=torch.bool, device=dev)
    keep = torch.arange(T, device=dev)[:, None] < input_lengths[None, :]
    lz = torch.where(logz <= LOG_EPS / 2, 0.0, logz)[:, None, None]
    b_in = final[None].expand(N, V, V)
    b_bl = b_in
    grad = torch.empty(T, N, V, device=dev)
    for seg in range(snap_in.shape[0] - 1, -1, -1):
        t0, t1 = seg * K, min((seg + 1) * K, T)
        a_in, a_bl = snap_in[seg], snap_bl[seg]
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
                torch.cat([rhs, rhs.masked_fill(eye, LOG_EPS)], dim=0), expw)
            blank_term = blank + b_bl
            new_in = torch.clamp_min(
                _lse_pair(_lse_pair(rhs, both[N:]), blank_term), LOG_EPS)
            new_bl = torch.clamp_min(_lse_pair(both[:N], blank_term), LOG_EPS)
            b_in = torch.where(active, new_in, b_in)
            b_bl = torch.where(active, new_bl, b_bl)
    return grad.transpose(0, 1) * g.float()[:, None, None]


MAX_V = 96  # the kernels' largest vocabulary

# The kernels' plan (`csrc/crf_dense.cu`). A thread-block cluster of C
# blocks runs a group of G utterances; block j owns the context symbols
# `owned(V, C, j)`, the column slices of the states for them, and, where
# it fits in shared memory, its slice expW[:, B_j, :] (else the same loop
# reads the slice from L2). Utterances are grouped by length, longest
# first, so a cluster loops only to its group's longest utterance.
SMEM_LIMIT = 232_448  # shared memory a block may take on the H100
MAX_CLUSTER = 16      # blocks a cluster (above 8: non-portable)
MAX_GROUP = 8         # utterances a cluster (the kernels' template range)


def owned(V, C, j):
    """The context symbols [lo, hi) that block j of a C-block cluster
    owns: floor(V / C) or ceil(V / C) of them."""
    return j * V // C, (j + 1) * V // C


def owner(V, C, u):
    """The block of a C-block cluster that owns symbol u, and u's index
    among its symbols."""
    j = ((u + 1) * C - 1) // V
    return j, u - j * V // C


def cluster_size(V):
    """Blocks a cluster: the largest power of two <= min(16, V)."""
    return 1 << (min(MAX_CLUSTER, V).bit_length() - 1)


def _al4(x):
    return -(-x // 4) * 4


def _smem_bytes(V, C, G, w_smem, backward):
    """Shared memory of one block of the plan, as `make_layout` of
    `csrc/crf_dense.cu` lays it out (that file refuses any other count)."""
    S = -(-V // C)
    col = V * S
    SC = _al4(G * col)
    n = _al4(V * ((S * V) | 1)) if w_smem else 0
    n += 2 * col * _al4(2 * G) + _al4(2 * G * col) + 2 * SC
    n += 5 * SC if backward else 0
    n += (_al4(4 * G * S) + _al4(2 * G * (S + 1)) + _al4(G * S) + _al4(2 * G)
          + 2 * _al4(4 * G) + _al4(2 * V))
    return 4 * n


class DenPlan:
    """How the den kernels split a batch: C blocks a cluster (S = ceil(V /
    C) symbols at most a block), G utterances a cluster in `groups`
    clusters, utterance order[k G : (k + 1) G] in cluster k (`order`: by
    length, longest first, int32 on the lengths' device), the expW slice
    resident in shared memory (`w_smem`) or read from L2, `smem_bytes` a
    block."""

    def __init__(self, C, G, N, V, w_smem, backward, order):
        self.C, self.G, self.V, self.w_smem = C, G, V, w_smem
        self.S = -(-V // C)
        self.groups = -(-N // G)
        self.smem_bytes = _smem_bytes(V, C, G, w_smem, backward)
        # backward scratch a block and frame: pre-update a_in, a_bl, emit0
        self.frame_scratch = 3 * _al4(G * V * self.S)
        self.order = order

    def __repr__(self):
        return (f"C={self.C} G={self.G} groups={self.groups} S={self.S} "
                f"W {'shared memory' if self.w_smem else 'L2'} "
                f"smem={self.smem_bytes} B")


def _layout(V, backward):
    """(C, W route, largest G) for V: the slice sits in shared memory
    where it fits beside one utterance's state."""
    C = cluster_size(V)
    w_smem = _smem_bytes(V, C, 1, True, backward) <= SMEM_LIMIT
    g_max = max(G for G in range(1, MAX_GROUP + 1)
                if _smem_bytes(V, C, G, w_smem, backward) <= SMEM_LIMIT)
    return C, w_smem, g_max


def den_plan(input_lengths, V, clusters, backward):
    """The plan for N = len(input_lengths) utterances over V classes on a
    card that holds `clusters` clusters of the largest group at once: as
    few utterances a cluster as fill those clusters, G = ceil(N /
    clusters) (at most the largest group that fits; more groups than
    clusters run in waves)."""
    N = int(input_lengths.shape[0])
    C, w_smem, g_max = _layout(V, backward)
    G = max(1, min(g_max, -(-N // max(clusters, 1))))
    order = torch.argsort(input_lengths, descending=True, stable=True)
    return DenPlan(C, G, N, V, w_smem, backward, order.to(torch.int32))


def _cluster_count(den, device, backward):
    """Clusters of the largest group that the card holds at once
    (`cudaOccupancyMaxActiveClusters`), once per device (kept with the
    denominator's device tables)."""
    key = ("clusters", str(torch.device(device)), backward)
    if key not in den._tables:
        V = den.num_classes
        C, w_smem, g_max = _layout(V, backward)
        out = np.zeros(1, np.int32)
        with torch.cuda.device(device):
            err = _build.load("crf_dense", _ENTRIES).den_clusters(
                out.ctypes.data, V, C, g_max, int(w_smem), int(backward),
                None)
        _build.check(err, "den_clusters")
        if out[0] < 1:
            raise RuntimeError(f"den kernels: the card holds no cluster of "
                               f"{C} blocks at V = {V}")
        den._tables[key] = int(out[0])
    return den._tables[key]


def _check(name, log_probs, input_lengths, den):
    N, T, V = log_probs.shape if log_probs.dim() == 3 else (0, 0, 0)
    if log_probs.dim() != 3 or log_probs.dtype != torch.float32 \
            or not log_probs.is_contiguous() \
            or input_lengths.dtype != torch.int64 \
            or tuple(input_lengths.shape) != (N,) \
            or input_lengths.device != log_probs.device:
        raise ValueError(f"{name}: the kernel takes contiguous f32 log-probs "
                         f"(N, T, V) and int64 lengths (N,) on one CUDA "
                         f"device, got {log_probs.dtype} "
                         f"{tuple(log_probs.shape)}, {input_lengths.dtype} "
                         f"{tuple(input_lengths.shape)}")
    if V != den.num_classes or V > MAX_V:
        raise ValueError(f"{name}: V = {V} against the denominator's "
                         f"{den.num_classes}; the kernels take V <= {MAX_V}")
    return N, T, V


def den_forward(log_probs, input_lengths, den):
    """The dense-den forward: ((a_in_snaps, a_bl_snaps), logz). Snapshots
    (S, N, V, V) f32, log domain, hold the alphas entering frames 0, K,
    2K, ... (S = ceil(T / K), K = den.ckpt_every); logz (N,). log_probs
    (N, T, V) f32, input_lengths (N,) int64. A CPU tensor takes
    `den_forward_reference`; a CUDA tensor launches `den_fwd` of
    `csrc/crf_dense.cu` or raises."""
    if log_probs.device.type == "cpu":
        return den_forward_reference(log_probs, input_lengths, den)
    N, T, V = _check("den_forward", log_probs, input_lengths, den)
    K = den.ckpt_every
    expw, final = den.device_tables(log_probs.device)
    plan = den_plan(input_lengths, V,
                    _cluster_count(den, log_probs.device, False), False)
    S = -(-T // K)
    snap_in, snap_bl = (log_probs.new_empty(S, N, V, V) for _ in range(2))
    logz = log_probs.new_empty(N)
    err = _build.load("crf_dense", _ENTRIES).den_fwd(
        log_probs.data_ptr(), input_lengths.data_ptr(),
        plan.order.data_ptr(), expw.data_ptr(), final.data_ptr(),
        snap_in.data_ptr(), snap_bl.data_ptr(), logz.data_ptr(), N, T, V, K,
        plan.C, plan.G, int(plan.w_smem), plan.smem_bytes,
        torch.cuda.current_stream(log_probs.device).cuda_stream)
    _build.check(err, "den_fwd")
    den_forward.launches += 1
    return (snap_in, snap_bl), logz


def den_backward(log_probs, input_lengths, snaps, logz, g, den):
    """The dense-den backward: d(sum_n g[n] logz[n]) / d log_probs, (N, T,
    V) f32, from `den_forward`'s snapshots and logz. A CPU tensor takes
    `den_backward_reference`; a CUDA tensor launches `den_bwd` of
    `csrc/crf_dense.cu` or raises."""
    if log_probs.device.type == "cpu":
        return den_backward_reference(log_probs, input_lengths, snaps, logz,
                                      g, den)
    N, T, V = _check("den_backward", log_probs, input_lengths, den)
    K = den.ckpt_every
    S = -(-T // K)
    snap_in, snap_bl = snaps
    g = g.float().contiguous()
    for t, shape in ((snap_in, (S, N, V, V)), (snap_bl, (S, N, V, V)),
                     (logz, (N,)), (g, (N,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != log_probs.device:
            raise ValueError(f"den_backward: expected contiguous f32 {shape} "
                             f"on {log_probs.device}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    expw, final = den.device_tables(log_probs.device)
    plan = den_plan(input_lengths, V,
                    _cluster_count(den, log_probs.device, True), True)
    grad = log_probs.new_empty(N, T, V)
    # per block: K frames of the pre-update a_in, a_bl and emit0 of its
    # G utterances' column slices
    scratch = log_probs.new_empty(plan.groups * plan.C, K,
                                  plan.frame_scratch)
    err = _build.load("crf_dense", _ENTRIES).den_bwd(
        log_probs.data_ptr(), input_lengths.data_ptr(),
        plan.order.data_ptr(), expw.data_ptr(), final.data_ptr(),
        snap_in.data_ptr(), snap_bl.data_ptr(), logz.data_ptr(), g.data_ptr(),
        grad.data_ptr(), scratch.data_ptr(), N, T, V, K, plan.C, plan.G,
        int(plan.w_smem), plan.smem_bytes,
        torch.cuda.current_stream(log_probs.device).cuda_stream)
    _build.check(err, "den_bwd")
    den_backward.launches += 1
    return grad


_ENTRIES = {"den_fwd": (8, 8, 0), "den_bwd": (11, 8, 0),
            "den_clusters": (1, 5, 0)}
den_forward.launches = 0
den_backward.launches = 0


class _DenLogPartition(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, input_lengths, den):
        lp = log_probs.float().contiguous()
        snaps, logz = den_forward(lp, input_lengths, den)
        ctx.save_for_backward(lp, input_lengths, logz, *snaps)
        ctx.den = den
        ctx.dtype = log_probs.dtype
        return logz

    @staticmethod
    def backward(ctx, g):
        lp, input_lengths, logz, snap_in, snap_bl = ctx.saved_tensors
        grad = den_backward(lp, input_lengths, (snap_in, snap_bl), logz, g,
                            ctx.den)
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
