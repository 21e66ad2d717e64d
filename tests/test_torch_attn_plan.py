"""The Dh = 64 attention forward kernel's tiling plan, on the CPU.

`csrc/relpos_attention_fwd.cu` (`relpos_attention_fwd_wgmma`) gives a
block 128 query rows, two consumers of 64 rows each, and walks key tiles
of 64 up to the utterance's length. For each tile pair a stage holds the
three 64-row boxes of the position table p from row T-128-t0+s0 (rows
outside the table are zeros), and a consumer reads the band of its
(query, key) scores at column c - r + 63 of its 128-row window. No card
and no nvcc here, so this file holds:
- `fwd_plan` (ops/attention.py), the coordinates the kernel computes,
  for every tile pair of T in {1, 63, 64, 65, 127, 128, 129, 300, 599}:
  every (query, key) pair reads table row T-1-t+s, and the rows that a
  valid pair reads lie in the table;
- a blocked emulation of the kernel's schedule with those coordinates:
  the query and key boxes read from the utterances' rows stacked as one
  (N·T, D) matrix with zeros past its end (as the tensor maps do),
  zero-filled table rows, the online softmax in f32, the probabilities
  scaled by the Philox keep factor of `dropout_scale` while the
  normaliser sums them undropped. Its out and lse are held against
  `relpos_attention_reference_lse` in f32 to 1e-5 (absolute and
  relative), at dropout rates 0 and 0.1, on ragged lengths (1, mid-tile
  and T), and at rate 0 against the JAX package's
  `relpos_attention_reference`.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cat_tpu.ops.attention_pallas import relpos_attention_reference
from cat_tpu_torch.ops import attention
from cat_tpu_torch.ops.attention import FWD_BK, FWD_BQ, NEG, fwd_plan
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


def emulate(q, k, v, p, u, vb, lengths, scale, rate=0.0, seed=None):
    """The kernel's schedule on the CPU: (out (N, T, H, Dh), lse (N, H,
    T))."""
    N, T, H, Dh = q.shape
    qf, kf, vf = (x.reshape(N * T, H, Dh) for x in (q, k, v))
    drop = (dropout_scale(seed, 0, N * H, T, T, rate).view(N, H, T, T)
            if rate > 0 else torch.ones(N, H, T, T))
    # the keep factors of rows and keys past T never reach the output
    drop = torch.nn.functional.pad(drop, (0, FWD_BK, 0, FWD_BQ))
    out = torch.zeros(N, T, H, Dh)
    lse = torch.zeros(N, H, T)
    for n in range(N):
        L = int(lengths[n])
        for h in range(H):
            for t0 in range(0, L, FWD_BQ):
                for w in (0, 1):
                    q_row = fwd_plan(T, t0, 0, w).q_row
                    if q_row >= L:  # the consumer has no valid row
                        continue
                    Q = _rows(qf[:, h], n * T + q_row, 64)
                    qu, qv = Q + u[h], Q + vb[h]
                    m = torch.full((64,), NEG)
                    l = torch.zeros(64)
                    O = torch.zeros(64, Dh)
                    for s0 in range(0, L, FWD_BK):
                        plan = fwd_plan(T, t0, s0, w)
                        K = _rows(kf[:, h], n * T + plan.kv_row, 64)
                        V = _rows(vf[:, h], n * T + plan.kv_row, 64)
                        stage = torch.cat([_rows(p[:, h], r, 64)
                                           for r in plan.p_rows])
                        win = stage[plan.win:plan.win + 128]
                        bd = (qv @ win.T).gather(1, plan.band)
                        S = (qu @ K.T + bd) * scale
                        S[:, s0 + torch.arange(64) >= L] = NEG
                        m_new = torch.maximum(m, S.max(1).values)
                        corr = torch.exp(m - m_new)
                        E = torch.exp(S - m_new[:, None])
                        l = l * corr + E.sum(1)
                        P = E * drop[n, h, q_row:q_row + 64, s0:s0 + 64]
                        O = O * corr[:, None] + P.to(q.dtype).float() @ V
                        m = m_new
                    r = torch.arange(64)
                    keep = (q_row + r < L) & (q_row + r < T)
                    out[n, q_row + r[keep], h] = (O / l[:, None])[keep]
                    lse[n, h, q_row + r[keep]] = (m + torch.log(l))[keep]
    return out, lse


def _inputs(T, seed):
    """N = 3 utterances of lengths T, one mid-tile and 1 (fewer for
    short T), H = 2, Dh = 64, numpy-normal from `seed`."""
    rng = np.random.default_rng(seed)
    N, H, Dh = 3, 2, 64
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * scale).astype(np.float32))
    q, k, v = f(N, T, H, Dh), f(N, T, H, Dh), f(N, T, H, Dh)
    p = f(2 * T - 1, H, Dh, scale=0.5)
    u, vb = f(H, Dh, scale=0.1), f(H, Dh, scale=0.1)
    lengths = torch.tensor([T, max(T - 37, 1), 1])
    return q, k, v, p, u, vb, lengths


@pytest.mark.parametrize("T", TS)
def test_fwd_plan_reads_the_band(T):
    for t0 in range(0, T, FWD_BQ):
        for s0 in range(0, T, FWD_BK):
            for w in (0, 1):
                plan = fwd_plan(T, t0, s0, w)
                assert plan.q_row == t0 + 64 * w and plan.kv_row == s0
                assert plan.p_rows == tuple(T - FWD_BQ - t0 + s0 + 64 * b
                                            for b in range(3))
                assert plan.win in (0, 64)
                t = plan.q_row + torch.arange(64)[:, None]
                s = plan.kv_row + torch.arange(64)[None, :]
                # every pair's table row, and within the consumer's window
                assert ((plan.band >= 0) & (plan.band < 127)).all()
                row = plan.p_rows[0] + plan.win + plan.band
                assert torch.equal(row, T - 1 - t + s)
                valid = (t < T) & (s < T)
                assert ((row[valid] >= 0) & (row[valid] < 2 * T - 1)).all()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T", TS)
def test_emulation_matches_plain(T, rate):
    q, k, v, p, u, vb, lengths = _inputs(T, seed=T)
    scale = 64 ** -0.5
    kw = dict(rate=rate, seed=SEED)
    got_out, got_lse = emulate(q, k, v, p, u, vb, lengths, scale, **kw)
    want_out, want_lse = attention.relpos_attention_reference_lse(
        q, k, v, p, u, vb, lengths, scale, **kw)
    torch.testing.assert_close(got_out, want_out, **TOL)
    torch.testing.assert_close(got_lse, want_lse, **TOL)


@pytest.mark.parametrize("T", [65, 300])
def test_emulation_matches_jax(T):
    q, k, v, p, u, vb, lengths = _inputs(T, seed=T + 1)
    got, _ = emulate(q, k, v, p, u, vb, lengths, 64 ** -0.5)
    kmask = np.arange(T)[None, :] < lengths.numpy()[:, None]
    want = np.asarray(relpos_attention_reference(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, p, u, vb)),
        jnp.asarray(kmask)))
    np.testing.assert_allclose(got.numpy()[kmask], want[kmask], **TOL)
