"""The schedule of the CTC lattice kernels' lanes route, on the CPU.

`csrc/ctc.cu` cannot run here, so this file pins what its lanes kernels
do before they meet the card:
- `ctc_plan`: the route and the warps a block at every S around the
  route's boundaries, its refusal of S = 0, and the constants it shares
  with the source.
- Where each thread's neighbours s-1 and s-2 (betas s+1 and s+2) come
  from: a shuffle within its warp, or for the two edge lanes the seam
  that the two facing lanes of the neighbouring warp wrote.
- A PyTorch emulation of `ctc_lanes_kernel`, written as the kernel is:
  one block an utterance, state s in thread s (lane s % 32 of warp
  s // 32), one frame a step, the neighbours' values of the previous step
  by shuffles or across the seam (double-buffered by frame parity), the
  emissions fetched LANES_PREFETCH steps ahead into a ring, threads past
  S holding LOG_EPS. The betas exchange b = max(em + beta, LOG_EPS), which
  each thread forms once. It asserts that every (t, s) is computed once,
  from values sent at the previous step, and holds its states bit for bit
  against the plain versions (`forward_alphas_reference`,
  `backward_betas_reference`: the same operands in the same order), and
  within the tolerance against the JAX package's Pallas kernels in
  interpret mode.
Inputs are made by numpy from a seed. Tolerance against the Pallas
kernels: rtol 1e-4, atol 1e-4 on live states; states at or below
LOG_EPS / 2 must be so on both sides.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ops.ctc_pallas import (backward_betas_pallas,
                                    forward_alphas_pallas)
from cat_tpu_torch.ops import ctc
from cat_tpu_torch.ops.semiring import LOG_EPS, logaddexp3

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
SOURCE = Path(ctc.__file__).resolve().parent.parent / "csrc" / "ctc.cu"

# (S, route, warps) at the boundaries of the lanes route's warp counts
PLANS = [(1, "lanes", 1), (2, "lanes", 1), (3, "lanes", 1), (31, "lanes", 1),
         (32, "lanes", 1), (33, "lanes", 2), (64, "lanes", 2),
         (65, "lanes", 3), (247, "lanes", 8), (256, "lanes", 8),
         (257, "lanes", 9), (1023, "lanes", 32), (1024, "lanes", 32),
         (1025, "frames", 0), (6001, "frames", 0)]
# (N, T, S, V, input lengths, label lengths): ragged lengths, a label of
# length 0, T = 1, and S at the warp boundaries (an even S leaves the last
# state padding)
CASES = {
    "ragged": (4, 9, 11, 7, [9, 7, 1, 5], [5, 3, 0, 2]),
    "one frame": (2, 1, 7, 5, [1, 1], [3, 0]),
    "no labels": (2, 5, 1, 4, [5, 3], [0, 0]),
    "S=2": (2, 4, 2, 4, [4, 2], [0, 0]),
    "S=3": (2, 4, 3, 4, [4, 2], [1, 0]),
}
for _s in (31, 32, 33, 63, 64, 65, 96, 97):
    CASES[f"S={_s}"] = (3, 6, _s, 9, [6, 1, 4],
                        [(_s - 1) // 2, (_s - 1) // 4, 0])


@pytest.mark.parametrize("S,route,warps", PLANS)
def test_ctc_plan(S, route, warps):
    assert ctc.ctc_plan(S) == ctc.CtcPlan(route, warps)


@pytest.mark.parametrize("S", [0, ctc.MAX_S + 1])
def test_ctc_plan_refuses_what_no_route_takes(S):
    with pytest.raises(ValueError, match="S = "):
        ctc.ctc_plan(S)


def test_constants_match_the_source():
    text = SOURCE.read_text()
    assert re.search(rf"LANES_MAX_WARPS = {ctc.LANES_MAX_WARPS};", text)
    assert re.search(rf"PREFETCH = {ctc.LANES_PREFETCH};", text)
    assert re.search(r"enum Route \{ FRAMES = 0, LANES = 1 \};", text)
    assert ctc.ROUTES == ("frames", "lanes")
    # the frames kernels' shared memory: two f32 rows and the skip bytes
    assert ctc.MAX_S * (2 * 4 + 1) <= 227 * 1024 < (ctc.MAX_S + 1) * 9


def sender(beta, slot):
    """The lane whose value a warp leaves in seam slot `slot` (0: the lane
    at the edge, alphas 31 and betas 0; 1: the lane beside it)."""
    return slot if beta else 31 - slot


def neighbour_sources(W, beta):
    """{(warp, lane, d): source}: where each thread's neighbour at distance
    d = 1, 2 (alphas s - d, betas s + d) comes from, as the kernel reads
    it: ("lane", warp, lane') by a shuffle within the warp; ("seam", warp',
    slot) for a lane within d of the warp's edge (alphas lanes 0 and 1,
    betas 31 and 30), the slot that `sender` of the warp before (after)
    wrote; None (LOG_EPS) past either end of the block."""
    out = {}
    for w in range(W):
        for lane in range(32):
            r = 31 - lane if beta else lane   # the distance from the edge
            for d in (1, 2):
                if d <= r:
                    out[w, lane, d] = ("lane", w,
                                       lane + d if beta else lane - d)
                else:
                    wf = w + 1 if beta else w - 1
                    out[w, lane, d] = (("seam", wf, d - r - 1)
                                       if 0 <= wf < W else None)
    return out


@pytest.mark.parametrize("beta", [False, True])
@pytest.mark.parametrize("W", [1, 2, 3, 8, 9, 32])
def test_each_thread_reads_its_neighbours(W, beta):
    """thread s = 32 w + lane reads s - 1 and s - 2 (alphas) or s + 1 and
    s + 2 (betas), across the warps' seams too; a thread reads the seam
    only from its two edge lanes, and only the two facing lanes send."""
    for (w, lane, d), src in neighbour_sources(W, beta).items():
        s, want = 32 * w + lane, 32 * w + lane + (d if beta else -d)
        if src is None:
            assert not 0 <= want < 32 * W, (s, d)
        elif src[0] == "lane":
            assert 32 * src[1] + src[2] == want, (s, d, src)
        else:
            assert (31 - lane if beta else lane) < 2, (s, d)
            assert 32 * src[1] + sender(beta, src[2]) == want, (s, d, src)
            assert sender(beta, src[2]) in ((0, 1) if beta else (30, 31))


def lanes(em, skip, beta_last=None, P=ctc.LANES_PREFETCH):
    """`ctc_lanes_kernel` in PyTorch: alphas of em (T, N, S) and allow2
    (N, S), or betas when beta_last (N, S) is given (skip then allow2_dst).
    Returns the states (T, N, S), asserting each was computed once, at its
    step, from values sent at the step before."""
    T, N, S = em.shape
    beta = beta_last is not None
    W = ctc.ctc_plan(S).warps
    s = torch.arange(32 * W)                                  # thread s
    on = s < S
    sc = s.clamp(max=S - 1)
    sk = on & ((s + 2 < S) if beta else (s >= 2)) & skip[:, sc]
    K = T - 1 if beta else T

    def frame(k):
        return T - 2 - k if beta else k

    def fetch(k):
        """The emissions of step k (N, 32 W), and the step they are for:
        alphas em[k], betas em[T - 2 - k] (frame 0's is never needed)."""
        f = frame(k)
        if (1 if beta else 0) <= f < T:
            return k, torch.where(on, em[f][:, sc], LOG_EPS)
        return k, torch.full((N, 32 * W), LOG_EPS)

    src = neighbour_sources(W, beta)
    senders = [[32 * w + sender(beta, q) for q in (0, 1)] for w in range(W)]
    out = torch.full((T, N, S), float("nan"))
    when = torch.full((T, S), -2, dtype=torch.long)
    if beta:
        last = torch.where(on, beta_last[:, sc], LOG_EPS)
        out[T - 1] = beta_last
        when[T - 1] = -1
        # v: b = max(em[T - 1] + beta[T - 1], LOG_EPS), what a thread sends
        v = torch.clamp_min(torch.where(on, em[T - 1][:, sc], LOG_EPS)
                            + last, LOG_EPS)
    else:
        v = torch.where(s == 0, 0.0, LOG_EPS).expand(N, 32 * W)
    # the seam by frame parity: the senders' values (N, W, slot) and the
    # step they were written at (-1: before the first step)
    seam = torch.empty(2, N, W, 2)
    seam_step = torch.full((2, W, 2), -3)
    for w in range(W):
        seam[1, :, w] = v[:, senders[w]]
        seam_step[1, w] = -1
    ring = [fetch(j) for j in range(P)]
    for k in range(K):
        for_k, x = ring[k % P]
        assert for_k == k                      # fetched P steps ahead
        ring[k % P] = fetch(k + P)
        xs = {d: torch.full((N, 32 * W), LOG_EPS) for d in (1, 2)}
        for (w, lane, d), sd in src.items():
            if sd is None:
                continue
            if sd[0] == "lane":
                xs[d][:, 32 * w + lane] = v[:, 32 * sd[1] + sd[2]]
            else:
                assert seam_step[(k + 1) % 2, sd[1], sd[2]] == k - 1
                xs[d][:, 32 * w + lane] = seam[(k + 1) % 2, :, sd[1], sd[2]]
        x2 = torch.where(sk, xs[2], LOG_EPS)
        if beta:
            y = torch.clamp_min(logaddexp3(v, xs[1], x2), LOG_EPS)
            v = torch.clamp_min(x + y, LOG_EPS)
        else:
            y = torch.clamp_min(x + logaddexp3(v, xs[1], x2), LOG_EPS)
            v = y
        assert (y[:, ~on] <= LOG_EPS / 2).all()   # past S: LOG_EPS
        t = frame(k)
        assert (when[t] == -2).all()              # computed once
        when[t] = k
        out[t] = y[:, :S]
        for w in range(W):
            seam[k % 2, :, w] = v[:, senders[w]]
            seam_step[k % 2, w] = k
    assert (when >= -1).all()                     # every state computed
    return out, when


def _case(name, seed):
    """em, allow2, allow2_dst, beta_last as `_CTCNll` builds them, from
    log-softmaxed numpy logits and labels with repeats (skips refused)."""
    N, T, S, V, ilens, llens = CASES[name]
    rng = np.random.default_rng(seed)
    U = S // 2                  # the lattice's label slots
    x = rng.standard_normal((N, T, V)).astype(np.float32) * 2
    lp = torch.log_softmax(torch.from_numpy(x), -1)
    labels = rng.integers(1, V, (N, U))
    labels[:, 1::3] = labels[:, 0:U - 1:3][:, :labels[:, 1::3].shape[1]]
    labels *= np.arange(U)[None, :] < np.array(llens)[:, None]
    labels, llens = torch.from_numpy(labels), torch.tensor(llens)
    ext, svalid, allow2 = ctc._lattice_tables(labels, llens, 0, S)
    em = ctc._emissions(lp, ext, svalid, torch.tensor(ilens), 0)
    return (em, allow2, *ctc._beta_tables(allow2, llens))


def _states(got, want):
    got, want = np.asarray(got), np.asarray(want)
    live = want > LOG_EPS / 2
    assert (got[~live] <= LOG_EPS / 2).all()
    np.testing.assert_allclose(got[live], want[live], **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_lanes_alphas(name):
    em, allow2, _, _ = _case(name, seed=3)
    alphas, when = lanes(em, allow2)
    assert torch.equal(when, torch.arange(em.shape[0])[:, None].expand_as(
        when))
    want = ctc.forward_alphas_reference(em, allow2)
    assert (want > LOG_EPS / 2).any()
    assert torch.equal(alphas, want)             # bit for bit
    _states(alphas, forward_alphas_pallas(jnp.asarray(em.numpy()),
                                          jnp.asarray(allow2.numpy()),
                                          interpret=True))


@pytest.mark.parametrize("name", list(CASES))
def test_lanes_betas(name):
    em, _, allow2_dst, beta_last = _case(name, seed=4)
    T = em.shape[0]
    betas, when = lanes(em, allow2_dst, beta_last)
    t = torch.arange(T)[:, None].expand_as(when)
    assert torch.equal(when, torch.where(t == T - 1, -1, T - 2 - t))
    want = ctc.backward_betas_reference(em, allow2_dst, beta_last)
    assert (want > LOG_EPS / 2).any()
    assert torch.equal(betas, want)              # bit for bit
    _states(betas, backward_betas_pallas(
        jnp.asarray(em.numpy()), jnp.asarray(allow2_dst.numpy()),
        jnp.asarray(beta_last.numpy()), interpret=True))


@pytest.mark.parametrize("P", [1, 4, 8])
def test_lanes_at_other_prefetch_depths(P):
    """The ring gives the same states at any depth (the depths the card's
    ablation builds)."""
    em, allow2, allow2_dst, beta_last = _case("S=65", seed=5)
    assert torch.equal(lanes(em, allow2, P=P)[0], lanes(em, allow2)[0])
    assert torch.equal(lanes(em, allow2_dst, beta_last, P=P)[0],
                       lanes(em, allow2_dst, beta_last)[0])


def test_lanes_at_the_crf_v1_width():
    """S = 247 (8 warps, the crf-v1 training batch's lattice) over a few
    frames, against the plain versions bit for bit."""
    rng = np.random.default_rng(6)
    N, T, S, V = 2, 5, 247, 72
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((N, T, V)).astype(np.float32) * 2), -1)
    labels = torch.from_numpy(rng.integers(1, V, (N, 123)))
    llens = torch.tensor([123, 74])
    labels *= torch.arange(123)[None, :] < llens[:, None]
    ext, svalid, allow2 = ctc._lattice_tables(labels, llens, 0, S)
    em = ctc._emissions(lp, ext, svalid, torch.tensor([T, 3]), 0)
    allow2_dst, beta_last = ctc._beta_tables(allow2, llens)
    assert torch.equal(lanes(em, allow2)[0],
                       ctc.forward_alphas_reference(em, allow2))
    assert torch.equal(lanes(em, allow2_dst, beta_last)[0],
                       ctc.backward_betas_reference(em, allow2_dst,
                                                    beta_last))
