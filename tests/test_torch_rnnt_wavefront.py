"""The schedule of the RNN-T lattice kernels' wavefront route, on the CPU.

`csrc/rnnt.cu` cannot run here, so this file pins what its wavefront
kernels do before they meet the card:
- `rnnt_plan`: the route and the warps a block at every U+1 around the
  route's boundaries, and the constants it shares with the source.
- A PyTorch emulation of `rnnt_wave_kernel`, written as the kernel is:
  one block an utterance, state u in thread u (lane u % 32 of warp
  u // 32), one anti-diagonal a step, the neighbour's state of the
  previous step by one shuffle from lane u - 1 (betas u + 1) or, for the
  edge lane, from the seam that the facing lane of the neighbouring warp
  wrote at that step (double-buffered by step parity), the table values
  fetched WAVE_PREFETCH steps ahead into a ring, the states carried in
  f64 with each step's log1p(exp) term in f32. It asserts every lattice
  node is computed exactly once, at step t + u (alphas) or (T-1-t) +
  (U-u) (betas), from values fetched and sent for that step, and holds
  its states against the plain versions (`forward_alphas_reference`,
  `backward_betas_reference`), the JAX package's Pallas kernels in
  interpret mode and its `lax.scan` path.
- The rounding at the rnnt-v1 training batch: the gradient rows of the
  f32 plain version, of the emulation with f32 states and of the
  emulation as built, each against the plain version on f64 copies of
  the tables (`test_f32_rounding_at_the_rnnt_v1_batch`).
Inputs are made by numpy from a seed, as tests/test_torch_rnnt.py makes
them. Tolerance: rtol 1e-4, atol 1e-4 on live states; states at or below
LOG_EPS / 2 must be so on both sides.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ops import rnnt as jax_rnnt
from cat_tpu.ops.rnnt_pallas import (backward_betas_pallas,
                                     forward_alphas_pallas)
from cat_tpu_torch.ops import rnnt
from cat_tpu_torch.ops.semiring import LOG_EPS

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
SOURCE = Path(rnnt.__file__).resolve().parent.parent / "csrc" / "rnnt.cu"

# (U1, route, warps) at the boundaries of the wavefront's warp counts
PLANS = [(1, "wavefront", 1), (2, "wavefront", 1), (31, "wavefront", 1),
         (32, "wavefront", 1), (33, "wavefront", 2), (64, "wavefront", 2),
         (65, "wavefront", 3), (83, "wavefront", 3), (96, "wavefront", 3),
         (97, "wavefront", 4), (256, "wavefront", 8), (257, "wavefront", 9),
         (1024, "wavefront", 32), (1025, "rowscan", 0), (1500, "rowscan", 0)]
# (N, T, U, V, input lengths, label lengths): tests/test_torch_rnnt.py's
# cases, then U+1 at the plan's boundaries at T of 1 and 24
CASES = {
    "ragged": (4, 11, 5, 7, [11, 9, 1, 6], [5, 3, 0, 2]),
    "one frame": (2, 1, 3, 5, [1, 1], [3, 0]),
    "no labels": (2, 6, 0, 4, [6, 4], [0, 0]),
    "wide": (2, 5, 40, 9, [5, 3], [40, 17]),
}
for _u1 in (32, 33, 64, 65, 96, 97, 256, 257):
    for _t in (1, 24):
        CASES[f"U+1={_u1} T={_t}"] = (
            3, _t, _u1 - 1, 9, [_t, 1, max(1, _t - 5)],
            [_u1 - 1, (_u1 - 1) // 2, 0])


@pytest.mark.parametrize("U1,route,warps", PLANS)
def test_rnnt_plan(U1, route, warps):
    assert rnnt.rnnt_plan(U1) == rnnt.RnntPlan(route, warps)


@pytest.mark.parametrize("U1", [0, rnnt.MAX_U1 + 1])
def test_rnnt_plan_refuses_what_no_route_takes(U1):
    with pytest.raises(ValueError, match="U\\+1"):
        rnnt.rnnt_plan(U1)


def test_constants_match_the_source():
    text = SOURCE.read_text()
    assert re.search(rf"WAVE_MAX_WARPS = {rnnt.WAVE_MAX_WARPS};", text)
    assert re.search(rf"PREFETCH = {rnnt.WAVE_PREFETCH};", text)
    assert re.search(r"enum Route \{ ROWSCAN = 0, WAVEFRONT = 1 \};", text)
    assert rnnt.ROUTES == ("rowscan", "wavefront")


def neighbour_sources(W, beta):
    """{(warp, lane): source}: where each thread's neighbour state comes
    from, as the kernel reads it: ("lane", warp, lane') by a shuffle from
    lane - 1 (betas lane + 1) of its own warp; for the edge lane (0, betas
    31) ("seam", warp'), the seam the facing lane of the warp before
    (after) wrote; None (LOG_EPS) past either end."""
    out = {}
    for w in range(W):
        for lane in range(32):
            if lane != (31 if beta else 0):
                out[w, lane] = ("lane", w, lane + (1 if beta else -1))
            else:
                wf = w + 1 if beta else w - 1
                out[w, lane] = ("seam", wf) if 0 <= wf < W else None
    return out


@pytest.mark.parametrize("beta", [False, True])
@pytest.mark.parametrize("W", [1, 2, 3, 8, 9, 32])
def test_each_thread_reads_the_neighbouring_state(W, beta):
    """thread u = 32 w + lane reads u - 1 (alphas) or u + 1 (betas), across
    the warps' seams too: a seam holds the state of the lane that sends
    (31 for alphas, 0 for betas)."""
    sender = 0 if beta else 31
    for (w, lane), src in neighbour_sources(W, beta).items():
        u, want = 32 * w + lane, 32 * w + lane + (1 if beta else -1)
        if src is None:
            assert not 0 <= want < 32 * W, u
        elif src[0] == "lane":
            assert 32 * src[1] + src[2] == want, (u, src)
        else:
            assert 32 * src[1] + sender == want, (u, src)


def lae(a, b):
    """The kernel's `lae_wide` on f64 states: the correction log1p(e^(mn -
    mx)) in f32 (on f32 states, f32 throughout)."""
    mx, mn = torch.maximum(a, b), torch.minimum(a, b)
    out = mx + torch.log1p(torch.exp((mn - mx).float())).to(a.dtype)
    return out.masked_fill(mx <= LOG_EPS / 2, LOG_EPS)


def wavefront(blank_eff, label_eff, term=None, P=rnnt.WAVE_PREFETCH,
              state=torch.float64):
    """`rnnt_wave_kernel` in PyTorch: alphas, or betas when `term` (N, U+1)
    is given. Returns the states (T, N, U+1) and the step at which each
    node was computed, asserting that each was computed once. `state`:
    the dtype the states are carried in (the kernel's f64, or f32 to
    measure what that would cost)."""
    T, N, U1 = blank_eff.shape
    beta = term is not None
    W = rnnt.rnnt_plan(U1).warps
    K, last = T + U1 - 1, T + U1 - 2
    u = torch.arange(32 * W)                                  # thread u
    on_u = u < U1
    uc = u.clamp(max=U1 - 1)
    if beta:
        v = torch.where(on_u, term[:, uc].to(state), LOG_EPS)  # (N, 32 W)
    else:
        v = torch.where(on_u & (u == 0), 0.0, LOG_EPS).to(state).expand(
            N, 32 * W)

    def frame(k):
        return last - k - u if beta else k - u

    def fetch(k):
        """The weights of step k (N, 32 W), and the step they are for."""
        t = frame(k)
        live = on_u & (t >= 0) & (t < T)
        tc = t.clamp(0, T - 1)
        if beta:
            b = torch.where(live, blank_eff[tc, :, uc].T, 0.0)
            l_ok = live & (u + 1 < U1)
            lab = label_eff[tc, :, uc].T
        else:
            b = torch.where(live & (t > 0),
                            blank_eff[(tc - 1).clamp(min=0), :, uc].T, 0.0)
            l_ok = live & (u > 0)
            lab = label_eff[tc, :, (uc - 1).clamp(min=0)].T
        return k, b, torch.where(l_ok, lab, LOG_EPS)

    src = neighbour_sources(W, beta)
    sender = 0 if beta else 31
    # the seam by step parity: the senders' states and the step they were
    # written at (-1: before the first step)
    seam = torch.empty(2, N, W, dtype=state)
    seam_step = torch.full((2, W), -2)
    seam[1] = v[:, sender::32]
    seam_step[1] = -1
    out = torch.full((T, N, U1), float("nan"))
    when = torch.full((T, U1), -1, dtype=torch.long)
    ring = [fetch(j) for j in range(P)]
    for k in range(K):
        for_k, b, lab = ring[k % P]
        assert for_k == k                      # fetched P steps ahead
        ring[k % P] = fetch(k + P)
        nb = torch.full((N, 32 * W), LOG_EPS, dtype=state)
        for (w, lane), s in src.items():
            if s is None:
                continue
            if s[0] == "lane":
                nb[:, 32 * w + lane] = v[:, 32 * s[1] + s[2]]
            else:
                assert seam_step[(k + 1) % 2, s[1]] == k - 1
                nb[:, 32 * w + lane] = seam[(k + 1) % 2, :, s[1]]
        t = frame(k)
        live = on_u & (t >= 0) & (t < T)
        new = torch.clamp_min(lae(torch.clamp_min(v + b, LOG_EPS),
                                  torch.clamp_min(nb + lab, LOG_EPS)),
                              LOG_EPS)
        v = torch.where(live, new, v)
        seam[k % 2] = v[:, sender::32]
        seam_step[k % 2] = k
        tl, ul = t[live], u[live]
        assert (when[tl, ul] == -1).all()      # computed once
        when[tl, ul] = k
        out[tl, :, ul] = v[:, live].T.float()
    assert (when >= 0).all()                   # every node computed
    return out, when


def _case(name, seed):
    N, T, U, V, ilens, llens = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, T, U + 1, V)).astype(np.float32) * 2
    lp = np.array(jax.nn.log_softmax(x, -1))
    labels = rng.integers(1, V, (N, U)).astype(np.int32)
    labels *= np.arange(U)[None, :] < np.array(llens)[:, None]
    ilens, llens = np.array(ilens, np.int32), np.array(llens, np.int32)
    be, le, _, _ = rnnt._row_tables(
        torch.from_numpy(lp), torch.from_numpy(labels),
        torch.from_numpy(ilens).long(), torch.from_numpy(llens).long(), 0)
    return be, le, llens


def _states(got, want):
    got, want = np.asarray(got), np.asarray(want)
    live = want > LOG_EPS / 2
    assert (got[~live] <= LOG_EPS / 2).all()
    np.testing.assert_allclose(got[live], want[live], **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_wavefront_alphas(name):
    be, le, _ = _case(name, seed=5)
    T, _, U1 = be.shape
    alphas, when = wavefront(be, le)
    t, u = torch.meshgrid(torch.arange(T), torch.arange(U1), indexing="ij")
    assert torch.equal(when, t + u)
    _states(alphas, rnnt.forward_alphas_reference(be, le))
    jbe, jle = jnp.asarray(be.numpy()), jnp.asarray(le.numpy())
    _states(alphas, forward_alphas_pallas(jbe, jle, interpret=True))
    _states(alphas, jax_rnnt._forward_alphas(jbe, jle))


@pytest.mark.parametrize("name", list(CASES))
def test_wavefront_betas(name):
    be, le, llens = _case(name, seed=6)
    T, _, U1 = be.shape
    term = rnnt.beta_term(torch.from_numpy(llens).long(), U1)
    betas, when = wavefront(be, le, term)
    t, u = torch.meshgrid(torch.arange(T), torch.arange(U1), indexing="ij")
    assert torch.equal(when, (T - 1 - t) + (U1 - 1 - u))
    _states(betas, rnnt.backward_betas_reference(be, le, term))
    jbe, jle = jnp.asarray(be.numpy()), jnp.asarray(le.numpy())
    want_b, want_term = jax_rnnt._backward_betas(jbe, jle, jnp.asarray(llens))
    _states(betas, backward_betas_pallas(jbe, jle, want_term, interpret=True))
    _states(betas, want_b)


@pytest.mark.parametrize("P", [1, 2, 8])
def test_wavefront_at_other_prefetch_depths(P):
    """The ring gives the same states at any depth (the depths the card's
    ablation builds)."""
    be, le, llens = _case("U+1=65 T=24", seed=7)
    term = rnnt.beta_term(torch.from_numpy(llens).long(), be.shape[2])
    for got, want in ((wavefront(be, le, P=P)[0], wavefront(be, le)[0]),
                      (wavefront(be, le, term, P=P)[0],
                       wavefront(be, le, term)[0])):
        assert torch.equal(got, want)


def _rnnt_v1_tables(seed):
    """The tables of chip_smoke.py's rnnt-v1 training batch: N = 32 frames
    T' = 299..493, labels U_n = T'_n // 6 ids in 1..1023, V = 1024,
    log-softmaxed logits 2·N(0, 1), made by numpy from a seed frame by
    frame. Returns (tables of `_row_tables`, input and label lengths)."""
    tl = [max(((1200 + 25 * k - 1) // 2 - 1) // 2, 1) for k in range(32)]
    N, T, V = len(tl), max(tl), 1024
    rng = np.random.default_rng(seed)
    llens = np.array([t // 6 for t in tl])
    U1 = llens.max() + 1
    labels = rng.integers(1, V, (N, U1 - 1))
    labels *= np.arange(U1 - 1)[None, :] < llens[:, None]
    idx = torch.from_numpy(np.pad(labels, ((0, 0), (0, 1))))[:, :, None]
    blank, label = torch.empty(N, T, U1), torch.empty(N, T, U1)
    for t in range(T):
        lp = torch.log_softmax(torch.from_numpy(rng.standard_normal(
            (N, U1, V), dtype=np.float32)) * 2, -1)
        blank[:, t], label[:, t] = lp[..., 0], lp.gather(2, idx)[..., 0]
    ilens, llens = torch.tensor(tl), torch.from_numpy(llens)
    frame_ok = torch.arange(T)[None, :, None] < ilens[:, None, None]
    u_ok = torch.arange(U1)[None, None, :] < llens[:, None, None]
    tr = lambda x: x.transpose(0, 1).contiguous()
    tables = (tr(torch.where(frame_ok, blank, 0.0)),
              tr(torch.where(frame_ok & u_ok, label, LOG_EPS)), tr(blank),
              tr(label))
    return tables, ilens, llens


def test_f32_rounding_at_the_rnnt_v1_batch(monkeypatch):
    """Why the wavefront carries its states in f64, and what the f32 plain
    version's own rounding is, measured against the plain version on f64
    copies of the tables (the witness) at the rnnt-v1 training batch,
    where the states reach about -4e3 (one f32 step 4.9e-4): the gradient
    rows (the posteriors of `rnnt.posteriors`, rounded to f32 as the loss
    forms them) of
    - the f32 plain version lie beyond chip_smoke.py's gate 1e-3 +
      1e-3·|witness| (2.8 times its distance at this seed): it sums each row as a
      Hillis-Steele scan, several roundings a node;
    - the wavefront with f32 states lie beyond it too (1.7 times), so
      that design could not meet the gate against the exact values;
    - the wavefront as built (f64 states, the correction in f32) lie
      within 0.37 of it.
    This is why chip_smoke.py gates the gradient rows against the witness
    and prints the f32 plain version's distance beside them."""
    tables, ilens, llens = _rnnt_v1_tables(seed=16)
    T, N, U1 = tables[0].shape
    term = rnnt.beta_term(llens, U1)

    def rows(tables, alphas, betas):
        ll = rnnt._final_ll(alphas, tables[0], llens)
        monkeypatch.setattr(rnnt, "backward_betas", lambda *a: betas)
        out = torch.stack(rnnt.posteriors(*tables, alphas, ll, ilens, llens,
                                          torch.ones(N)))
        monkeypatch.undo()
        return out.double()

    wide = [x.double() for x in tables]
    want = rows(wide, rnnt.forward_alphas_reference(*wide[:2]),
                rnnt.backward_betas_reference(*wide[:2], term))
    assert want.max() > 0.5                     # live posteriors
    gate = 1e-3 + 1e-3 * want.abs()

    def over(alphas, betas):
        got = rows(tables, alphas.float(), betas.float())
        assert got.isfinite().all()
        return ((got - want).abs() / gate).max().item()

    plain = over(rnnt.forward_alphas_reference(*tables[:2]),
                 rnnt.backward_betas_reference(*tables[:2], term))
    wave32 = over(wavefront(*tables[:2], state=torch.float32)[0],
                  wavefront(*tables[:2], term, state=torch.float32)[0])
    wave64 = over(wavefront(*tables[:2])[0],
                  wavefront(*tables[:2], term)[0])
    assert plain > 1.0, plain
    assert wave32 > 1.0, wave32
    assert wave64 < 0.5, wave64
