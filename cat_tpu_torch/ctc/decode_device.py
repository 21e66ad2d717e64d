"""Batched CTC prefix beam search on the log-probs' device (counterpart of
`cat_tpu/ctc/decode_jax.py`).

Beams are lanes of fixed shape: every frame does the same dense work on
the card, with no host round trip, and prefixes that meet are merged
exactly. Per frame (batch N, beams W, top-K expansion):
  1. candidates: W "stay" lanes (blank or repeat keep the prefix) and
     W·K "extend" lanes (append one of the frame's top K tokens);
  2. a lexicographic stable sort of the C = W·(K+1) lanes by a 64-bit
     prefix hash (two 32-bit halves);
  3. a segmented logaddexp over runs of equal hash merges duplicate
     prefixes: a scan of ceil(log2 C) doubling steps with reset flags;
  4. the W best merged lanes survive, their prefix arrays gathered from
     their parents with the new token written in place.

Equal to the JAX function where it matters: the hashes are computed in
int64 and wrapped to int32 as JAX's int32 arithmetic wraps; both top-K
selections are stable descending sorts, so ties go to the lower index as
`jax.lax.top_k` sends them; the hash sort is a stable argsort. Nothing
sums with atomics (no `scatter_add`), so two calls on the card agree bit
for bit. The rounding of the merge differs from JAX's associative scan
only within runs of three or more lanes.
"""
from __future__ import annotations

import math

import torch

from cat_tpu_torch.ops.semiring import LOG_EPS, safe_logaddexp

_P1, _P2 = 1000003, 1009


def _wrap32(x):
    """int64 values wrapped to the int32 range, as int32 arithmetic
    wraps."""
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def _top(x, k):
    """(values, indices) of the k largest along dim 1, ties to the lower
    index (`jax.lax.top_k`'s order)."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _seg_merge(values, flags):
    """Segmented logaddexp along dim 1 over runs that start where `flags`
    is True: the running total at each position, the full merge at the
    last position of each run. A doubling scan: step d combines position
    i with i - d unless a run starts between them."""
    C = values.shape[1]
    for s in range(math.ceil(math.log2(max(C, 2)))):
        d = 1 << s
        if d >= C:
            break
        prev_v, prev_f = values[:, :-d], flags[:, :-d]
        cur_v, cur_f = values[:, d:], flags[:, d:]
        values = torch.cat([values[:, :d], torch.where(
            cur_f, cur_v, safe_logaddexp(prev_v, cur_v))], dim=1)
        flags = torch.cat([flags[:, :d], cur_f | prev_f], dim=1)
    return values


def ctc_beam_search_device(log_probs, lengths, beam_width=8, topk=8,
                           max_len=128, blank=0, beta=0.0):
    """Batched prefix beam search on the device of `log_probs`.

    Args:
      log_probs: (N, T, V) log-softmax outputs (a tensor); float64 ones
        are searched in float64 (a witness), any other in float32.
      lengths: (N,) frame counts.
      beta: a bonus added on every prefix extension (ctcdecode's word
        bonus; negative: an insertion penalty).
      max_len: the prefix capacity; a prefix at it extends no further.
    Returns:
      prefixes (N, W, max_len) int32 (0-padded), plens (N, W) int32 and
      scores (N, W) total log-probabilities in the search's dtype, best
      first.
    """
    lp = torch.as_tensor(log_probs)
    if lp.dtype != torch.float64:
        lp = lp.float()
    dev = lp.device
    N, T, V = lp.shape
    W, K = beam_width, min(topk, V)
    C = W * (K + 1)
    lengths = torch.as_tensor(lengths, device=dev).long()
    i64 = dict(dtype=torch.int64, device=dev)

    pb = torch.full((N, W), LOG_EPS, dtype=lp.dtype, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((N, W), LOG_EPS, dtype=lp.dtype, device=dev)
    pref = torch.zeros((N, W, max_len), **i64)
    plen = torch.zeros((N, W), **i64)
    lane = torch.arange(W, **i64)
    h1 = (lane * 7919).expand(N, W).clone()    # dead lanes distinct
    h2 = (lane * 104729).expand(N, W).clone()
    last = torch.full((N, W), -1, **i64)
    parent = torch.cat([lane, lane.repeat_interleave(K)]).expand(N, C)
    stay_tok = torch.full((N, W), -1, **i64)
    stay_pb_ext = torch.full((N, W * K), LOG_EPS, dtype=lp.dtype,
                             device=dev)
    first = torch.ones((N, 1), dtype=torch.bool, device=dev)
    g = torch.gather

    for t in range(T):
        y_t = lp[:, t]                                       # (N, V)
        active = (t < lengths)[:, None]                      # (N, 1)
        ptot = safe_logaddexp(pb, pnb)
        top_v, top_i = _top(y_t, K)                          # (N, K)

        # stay lanes: blank, and the repeat of the last token
        stay_pb = ptot + y_t[:, blank][:, None]
        y_last = g(y_t, 1, torch.clamp_min(last, 0))
        stay_pnb = torch.where(last >= 0, pnb + y_last, LOG_EPS)

        # extend lanes (W·K)
        v = top_i[:, None, :].expand(N, W, K)
        sc = top_v[:, None, :].expand(N, W, K)
        is_rep = v == last[:, :, None]
        base = torch.where(is_rep, pb[:, :, None], ptot[:, :, None])
        ext_pnb = base + sc + beta
        ext_pnb = torch.where(v == blank, LOG_EPS, ext_pnb)
        ext_pnb = torch.where(plen[:, :, None] >= max_len, LOG_EPS, ext_pnb)
        ext_h1 = _wrap32(h1[:, :, None] * _P1 + (v + 1))
        ext_h2 = _wrap32(h2[:, :, None] * _P2 + (v + 1))

        cand_pb = torch.cat([stay_pb, stay_pb_ext], 1)
        cand_pnb = torch.cat([stay_pnb, ext_pnb.reshape(N, W * K)], 1)
        cand_h1 = torch.cat([h1, ext_h1.reshape(N, W * K)], 1)
        cand_h2 = torch.cat([h2, ext_h2.reshape(N, W * K)], 1)
        tok = torch.cat([stay_tok, v.reshape(N, W * K)], 1)

        # lexicographic stable sort by (h1, h2)
        o2 = torch.argsort(cand_h2, dim=1, stable=True)
        o1 = torch.argsort(g(cand_h1, 1, o2), dim=1, stable=True)
        order = g(o2, 1, o1)
        cand_pb, cand_pnb = g(cand_pb, 1, order), g(cand_pnb, 1, order)
        cand_h1, cand_h2 = g(cand_h1, 1, order), g(cand_h2, 1, order)
        par, tok = g(parent, 1, order), g(tok, 1, order)

        diff = (cand_h1[:, 1:] != cand_h1[:, :-1]) \
            | (cand_h2[:, 1:] != cand_h2[:, :-1])
        new_seg = torch.cat([first, diff], 1)
        m_pb = _seg_merge(cand_pb, new_seg)
        m_pnb = _seg_merge(cand_pnb, new_seg)
        run_end = torch.cat([diff, first], 1)
        total = torch.where(run_end, safe_logaddexp(m_pb, m_pnb), LOG_EPS)

        # the W best merged lanes
        _, sel = _top(total, W)
        n_pb, n_pnb = g(m_pb, 1, sel), g(m_pnb, 1, sel)
        n_h1, n_h2 = g(cand_h1, 1, sel), g(cand_h2, 1, sel)
        n_par, n_tok = g(par, 1, sel), g(tok, 1, sel)

        # their prefixes: the parent's, with the new token at its end
        par_pref = g(pref, 1, n_par[:, :, None].expand(N, W, max_len))
        par_plen = g(plen, 1, n_par)
        par_last = g(last, 1, n_par)
        is_ext = n_tok >= 0
        pos = torch.clamp_max(par_plen, max_len - 1)[:, :, None]
        put = torch.where(is_ext[:, :, None], n_tok[:, :, None],
                          g(par_pref, 2, pos))
        n_pref = par_pref.scatter(2, pos, put)
        n_plen = par_plen + is_ext.long()
        n_last = torch.where(is_ext, n_tok, par_last)

        # frames past an utterance's length keep its state
        pb = torch.where(active, n_pb, pb)
        pnb = torch.where(active, n_pnb, pnb)
        pref = torch.where(active[:, :, None], n_pref, pref)
        plen = torch.where(active, n_plen, plen)
        h1 = torch.where(active, n_h1, h1)
        h2 = torch.where(active, n_h2, h2)
        last = torch.where(active, n_last, last)

    total = safe_logaddexp(pb, pnb)
    order = torch.argsort(-total, dim=1, stable=True)
    return (g(pref, 1, order[:, :, None].expand(N, W, max_len)).int(),
            g(plen, 1, order).int(), g(total, 1, order))
