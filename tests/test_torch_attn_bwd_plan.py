"""The Dh = 64 attention backward's plan and schedule, on the CPU.

At Dh = 64 `relpos_attention_backward` launches three kernels of
`csrc/relpos_attention_bwd.cu`:
- `relpos_attention_bwd_dq_wgmma`, a pass in the forward's orientation
  (128 query rows a block, two consumers of 64, key tiles of 64 up to
  the utterance's length, the forward's window of the position table).
  A consumer keeps dqu and dqv in registers, scatters dS into its 64 x
  128 window gradient dQP at column c - r + 63, and carries a rolling dp
  window of 128 table rows: after each key tile the lower 64 rows are
  final and go to its workspace slot, the upper 64 become the next
  tile's lower half. It writes dq in bf16 and its column sums of dqu and
  dqv (du and dv_bias partials);
- `relpos_attention_bwd_reduce`, which sums the slots' dp rows and the
  du and dv_bias partials in a fixed order (utterance, then sub-tile);
- `relpos_attention_bwd_dkdv_wgmma`, a key-major pass (128 keys a
  block, two consumers of 64, query tiles of 64 up to the utterance's
  length, the window of `bwd_kv_plan`). A consumer keeps dK and dV in
  registers, forms its own qu and qv from each query tile, recomputes
  the scores with the band as the dq pass does, and adds Pdᵀ·dO and
  dSᵀ·qu.
No card and no nvcc here, so this file holds:
- `bwd_plan`, `bwd_kv_plan` and the slot helpers of ops/attention.py,
  for T in {1, 63, 64, 65, 127, 128, 129, 300, 599}: every (query, key)
  pair scatters to, or reads, table row T-1-t+s, the slots' ranges cover
  every row a valid pair writes, and no two flushes of one slot write
  the same row;
- a blocked emulation of the three kernels in f32 with those
  coordinates (query, key and dO boxes read from the utterances' rows
  stacked as one (N·T, D) matrix with zeros past its end, as the tensor
  maps do; zero-filled table rows; the workspace, dK, dV and the
  consumers' qu and qv filled with NaN first, so that a row the schedule
  does not write, or reads before it writes, shows). All six
  outputs are held against `relpos_attention_backward_reference` to
  1e-5 (absolute and relative) at dropout rates 0 and 0.1 on ragged
  lengths (1, mid-tile and T), and at rate 0 against `jax.grad` of the
  JAX package's `relpos_attention_reference`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ops.attention_pallas import relpos_attention_reference
from cat_tpu_torch.ops import attention
from cat_tpu_torch.ops.attention import (FWD_BK, FWD_BQ, bwd_kv_plan,
                                         bwd_plan, bwd_slot_rows, bwd_slots,
                                         bwd_workspace_rows)
from cat_tpu_torch.ops.dropout import dropout_scale

torch.set_num_threads(2)
TS = [1, 63, 64, 65, 127, 128, 129, 300, 599]
TOL = dict(atol=1e-5, rtol=1e-5)
SEED = (0x12345678, 0x9ABCDEF0)


def _rows(mat, start, count):
    """Rows start .. start + count - 1 of mat, zeros outside it (TMA)."""
    out = mat.new_zeros(count, *mat.shape[1:])
    lo, hi = max(start, 0), min(start + count, mat.shape[0])
    if lo < hi:
        out[lo - start:hi - start] = mat[lo:hi]
    return out


def _keep(N, H, T, rate, seed):
    """Keep factors (N, H, T + 128, T + 64): rows and keys past T are
    never valid."""
    drop = (dropout_scale(seed, 0, N * H, T, T, rate).view(N, H, T, T)
            if rate > 0 else torch.ones(N, H, T, T))
    return torch.nn.functional.pad(drop, (0, FWD_BK, 0, FWD_BQ))


def emulate_dq_pass(q, k, v, p, u, vb, lengths, lse, delta, dout, drop,
                    scale):
    """`relpos_attention_bwd_dq_wgmma`: (dq, workspace, du partials, dv_bias
    partials), the workspace (N·J·SR, H, Dh) with NaN where no flush
    wrote."""
    N, T, H, Dh = q.shape
    J, SR = -(-T // 64), bwd_workspace_rows(T)
    qf, kf, vf, gf = (x.reshape(N * T, H, Dh) for x in (q, k, v, dout))
    dq = torch.zeros(N, T, H, Dh)
    ws = torch.full((N * J * SR, H, Dh), float("nan"))
    wdu = torch.full((N * J, H, Dh), float("nan"))
    wdv = torch.full((N * J, H, Dh), float("nan"))
    r = torch.arange(64)
    for n in range(N):
        L = int(lengths[n])
        nkt = -(-L // FWD_BK)
        for h in range(H):
            for t0 in range(0, L, FWD_BQ):
                for w in (0, 1):
                    q_row = bwd_plan(T, t0, 0, w).fwd.q_row
                    if q_row >= L:  # the consumer has no valid row
                        continue
                    Q = _rows(qf[:, h], n * T + q_row, 64)
                    qu, qv = Q + u[h], Q + vb[h]
                    dO = _rows(gf[:, h], n * T + q_row, 64)
                    row_ok = q_row + r < L
                    lse_r = torch.where(row_ok, _rows(lse[n, h], q_row, 64),
                                        0.0)
                    dl_r = torch.where(row_ok, _rows(delta[n, h], q_row, 64),
                                       0.0)
                    dqu, dqv = torch.zeros(64, Dh), torch.zeros(64, Dh)
                    carry = torch.zeros(64, Dh)
                    for kt in range(nkt):
                        plan = bwd_plan(T, t0, kt * FWD_BK, w)
                        f = plan.fwd
                        K = _rows(kf[:, h], n * T + f.kv_row, 64)
                        V = _rows(vf[:, h], n * T + f.kv_row, 64)
                        stage = torch.cat([_rows(p[:, h], x, 64)
                                           for x in f.p_rows])
                        win = stage[f.win:f.win + 128]
                        bd = (qv @ win.T).gather(1, f.band)
                        S = (qu @ K.T + bd) * scale
                        ok = row_ok[:, None] & (f.kv_row + r < L)[None, :]
                        P = torch.where(ok, torch.exp(S - lse_r[:, None]),
                                        0.0)
                        keep = drop[n, h, q_row:q_row + 64,
                                    f.kv_row:f.kv_row + 64]
                        dS = (P * ((dO @ V.T) * keep - dl_r[:, None])
                              * scale).to(q.dtype).float()
                        dqu += dS @ K
                        dqp = torch.zeros(64, 128).scatter_(1, plan.scatter,
                                                            dS)
                        dqv += dqp @ win
                        carry += dqp[:, :64].T @ qv
                        base = (n * J + plan.slot) * SR
                        ws[base + plan.slot_row:base + plan.slot_row + 64,
                           h] = carry
                        carry = dqp[:, 64:].T @ qv
                    ws[base + 64 * nkt:base + 64 * nkt + 64, h] = carry
                    keep_rows = row_ok & (q_row + r < T)
                    dq[n, q_row + r[keep_rows], h] = (dqu + dqv)[keep_rows]
                    wdu[n * J + plan.slot, h] = dqu.sum(0)
                    wdv[n * J + plan.slot, h] = dqv.sum(0)
    return dq.to(q.dtype), ws, wdu, wdv


def emulate_reduce(ws, wdu, wdv, lengths, T):
    """`relpos_attention_bwd_reduce`: dp (2T-1, H, Dh), du, dv_bias."""
    H, Dh = ws.shape[1:]
    J = -(-T // 64)
    dp = torch.zeros(2 * T - 1, H, Dh)
    du, dvb = torch.zeros(H, Dh), torch.zeros(H, Dh)
    for n, j, first, rows, off in bwd_slots(T, lengths):
        m = torch.arange(first, first + rows)
        inside = (m >= 0) & (m < 2 * T - 1)
        dp[m[inside]] += ws[off + torch.nonzero(inside)[:, 0]]
        du += wdu[n * J + j]
        dvb += wdv[n * J + j]
    return dp, du, dvb


def emulate_dkdv_pass(q, k, v, p, u, vb, lengths, lse, delta, dout, drop,
                      scale):
    """`relpos_attention_bwd_dkdv_wgmma`: (dk, dv). A block per 128-key
    tile, a consumer per 64 keys, walking the query tiles of 64 with the
    window of `bwd_kv_plan`; dK, dV and the consumer's qu and qv start as
    NaN."""
    N, T, H, Dh = q.shape
    qf, kf, vf, gf = (x.reshape(N * T, H, Dh) for x in (q, k, v, dout))
    dk = torch.full((N, T, H, Dh), float("nan"))
    dv = torch.full((N, T, H, Dh), float("nan"))
    r = torch.arange(64)
    for n in range(N):
        L = int(lengths[n])
        for h in range(H):
            for s0 in range(0, T, 128):
                for w in (0, 1):
                    k0 = bwd_kv_plan(T, 0, s0, w).kv_row
                    rows = k0 + r[k0 + r < T]
                    if k0 >= L:  # no valid key: zeros
                        dk[n, rows, h] = 0.0
                        dv[n, rows, h] = 0.0
                        continue
                    K = _rows(kf[:, h], n * T + k0, 64)
                    V = _rows(vf[:, h], n * T + k0, 64)
                    key_ok = k0 + r < L
                    aK, aV = torch.zeros(64, Dh), torch.zeros(64, Dh)
                    qu = torch.full((64, Dh), float("nan"))
                    qv = torch.full((64, Dh), float("nan"))
                    for t0 in range(0, L, 64):
                        f = bwd_kv_plan(T, t0, s0, w)
                        Q = _rows(qf[:, h], n * T + f.q_row, 64)
                        qu[:], qv[:] = Q + u[h], Q + vb[h]
                        dO = _rows(gf[:, h], n * T + f.q_row, 64)
                        stage = torch.cat([_rows(p[:, h], x, 64)
                                           for x in f.p_rows])
                        win = stage[f.win:f.win + 128]
                        bd = (qv @ win.T).gather(1, f.band)
                        S = (qu @ K.T + bd) * scale
                        row_ok = f.q_row + r < L
                        lse_r = torch.where(row_ok,
                                            _rows(lse[n, h], f.q_row, 64),
                                            0.0)
                        dl_r = torch.where(row_ok,
                                           _rows(delta[n, h], f.q_row, 64),
                                           0.0)
                        ok = row_ok[:, None] & key_ok[None, :]
                        P = torch.where(ok, torch.exp(S - lse_r[:, None]),
                                        0.0)
                        keep = drop[n, h, f.q_row:f.q_row + 64,
                                    k0:k0 + 64]
                        Pd = (P * keep).to(q.dtype).float()
                        dS = (P * ((dO @ V.T) * keep - dl_r[:, None])
                              * scale).to(q.dtype).float()
                        aV += Pd.T @ dO
                        aK += dS.T @ qu
                    n_rows = len(rows)
                    dk[n, rows, h] = torch.where(key_ok[:, None], aK,
                                                 0.0)[:n_rows]
                    dv[n, rows, h] = torch.where(key_ok[:, None], aV,
                                                 0.0)[:n_rows]
    return dk.to(q.dtype), dv.to(q.dtype)


def emulate(q, k, v, p, u, vb, lengths, out, lse, dout, scale, rate=0.0,
            seed=None):
    """The three launches of the Dh = 64 route: (dq, dk, dv, dp, du,
    dv_bias)."""
    N, T, H, Dh = q.shape
    drop = _keep(N, H, T, rate, seed)
    # Delta = dO . O, computed by the wrapper
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)
    dq, ws, wdu, wdv = emulate_dq_pass(q, k, v, p, u, vb, lengths, lse,
                                       delta, dout, drop, scale)
    dp, du, dvb = emulate_reduce(ws, wdu, wdv, lengths, T)
    dk, dv = emulate_dkdv_pass(q, k, v, p, u, vb, lengths, lse, delta,
                               dout, drop, scale)
    return dq, dk, dv, dp, du, dvb


def _inputs(T, seed):
    """N = 3 utterances of lengths T, one mid-tile and 1 (fewer for short
    T), H = 2, Dh = 64, numpy-normal from `seed`; dO zero on padded
    rows, as the layer gives it."""
    rng = np.random.default_rng(seed)
    N, H, Dh = 3, 2, 64
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * scale).astype(np.float32))
    q, k, v = f(N, T, H, Dh), f(N, T, H, Dh), f(N, T, H, Dh)
    p = f(2 * T - 1, H, Dh, scale=0.5)
    u, vb = f(H, Dh, scale=0.1), f(H, Dh, scale=0.1)
    lengths = torch.tensor([T, max(T - 37, 1), 1])
    kmask = torch.arange(T)[None, :] < lengths[:, None]
    dout = f(N, T, H, Dh) * kmask[:, :, None, None]
    return (q, k, v, p, u, vb, lengths), dout


@pytest.mark.parametrize("T", TS)
def test_bwd_plan_scatters_the_band(T):
    L = T
    for t0 in range(0, T, FWD_BQ):
        for w in (0, 1):
            first_j = None
            written = []
            for s0 in range(0, T, FWD_BK):
                plan = bwd_plan(T, t0, s0, w)
                f = plan.fwd
                want = attention.fwd_plan(T, t0, s0, w)
                assert f[:4] == want[:4] and torch.equal(f.band, want.band)
                assert plan.slot == f.q_row // 64
                first_j = plan.slot if first_j is None else first_j
                assert plan.slot == first_j
                first, rows = bwd_slot_rows(T, plan.slot, L)
                t = f.q_row + torch.arange(64)[:, None]
                s = f.kv_row + torch.arange(64)[None, :]
                # every pair scatters within the 127 used window columns,
                # to its table row
                assert ((plan.scatter >= 0) & (plan.scatter < 127)).all()
                row = plan.flush_row + plan.scatter
                assert torch.equal(row, T - 1 - t + s)
                assert plan.flush_row == f.p_rows[0] + f.win
                # the rows a valid pair writes lie in the table and in the
                # slot's range, at slot row table row - first
                valid = (t < L) & (s < L)
                assert ((row[valid] >= 0) & (row[valid] < 2 * T - 1)).all()
                assert ((row[valid] >= first)
                        & (row[valid] < first + rows)).all()
                assert plan.slot_row == plan.flush_row - first
                written.append(range(plan.slot_row, plan.slot_row + 64))
            # the flush after the last key tile: the window's upper half
            written.append(range(plan.slot_row + 64, plan.slot_row + 128))
            rows_seen = [x for rg in written for x in rg]
            # no two flushes of one slot write the same row, and together
            # they write the slot whole
            assert len(rows_seen) == len(set(rows_seen))
            assert sorted(rows_seen) == list(range(rows))
            assert rows <= bwd_workspace_rows(T)


@pytest.mark.parametrize("T", TS)
def test_bwd_kv_plan_reads_the_band(T):
    r = torch.arange(64)
    for s0 in range(0, T, 128):
        for w in (0, 1):
            for t0 in range(0, T, 64):
                f = bwd_kv_plan(T, t0, s0, w)
                assert (f.q_row, f.kv_row) == (t0, s0 + 64 * w)
                # three contiguous boxes, the first from T-64-t0+s0, and
                # the consumer's 128-row window inside them
                assert f.p_rows == tuple(T - 64 - t0 + s0 + 64 * b
                                         for b in range(3))
                assert f.win == 64 * w and f.win + 128 <= 192
                assert ((f.band >= 0) & (f.band < 127)).all()
                t = f.q_row + r[:, None]
                s = f.kv_row + r[None, :]
                # every pair reads its table row T-1-t+s
                assert torch.equal(f.p_rows[0] + f.win + f.band,
                                   T - 1 - t + s)
                # the rows a valid pair reads lie in the table
                row = f.p_rows[0] + f.win + f.band
                valid = (t < T) & (s < T)
                assert ((row[valid] >= 0) & (row[valid] < 2 * T - 1)).all()
                # the band is the forward's: the same window column for
                # the same (query, key) offsets
                assert torch.equal(f.band,
                                   attention.fwd_plan(T, 0, 0, 0).band)


@pytest.mark.parametrize("T", TS)
def test_bwd_slots_order_and_bounds(T):
    lengths = [T, max(T - 37, 1), 1, 0]
    slots = bwd_slots(T, lengths)
    J, SR = -(-T // 64), bwd_workspace_rows(T)
    assert [(n, j) for n, j, *_ in slots] == sorted(
        (n, j) for n, L in enumerate(lengths) for j in range(-(-L // 64)))
    for n, j, first, rows, off in slots:
        assert (first, rows) == bwd_slot_rows(T, j, lengths[n])
        assert off == (n * J + j) * SR and rows <= SR


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T", TS)
def test_emulation_matches_plain(T, rate):
    args, dout = _inputs(T, seed=T)
    scale = 64 ** -0.5
    kw = dict(rate=rate, seed=SEED)
    out, lse = attention.relpos_attention_reference_lse(*args, scale, **kw)
    got = emulate(*args, out, lse, dout, scale, **kw)
    want = attention.relpos_attention_backward_reference(
        *args, out, lse, dout, scale, **kw)
    for name, a, b in zip("dq dk dv dp du dv_bias".split(), got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, **TOL, msg=name)


@pytest.mark.parametrize("T", [65, 300])
def test_emulation_matches_jax(T):
    args, dout = _inputs(T, seed=T + 1)
    lengths = args[6]
    scale = 64 ** -0.5
    out, lse = attention.relpos_attention_reference_lse(*args, scale)
    got = emulate(*args, out, lse, dout, scale)
    kmask = jnp.asarray(np.arange(T)[None, :] < lengths.numpy()[:, None])
    g = jnp.asarray(dout.numpy())
    want = jax.grad(
        lambda *a: jnp.sum(relpos_attention_reference(*a, kmask) * g),
        argnums=tuple(range(6)))(*(jnp.asarray(x.numpy())
                                   for x in args[:6]))
    for name, a, b in zip("dq dk dv dp du dv_bias".split(), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   **TOL, err_msg=name)
