"""The dense-den kernels' plan and their cluster schedule, on the CPU.

`csrc/crf_dense.cu` splits each utterance's (V, V) states over a
thread-block cluster by column (context symbol b) and exchanges rows
through distributed shared memory in buffers double-buffered by frame
parity, with one cluster barrier a frame. No card and no nvcc here, so
this file holds:
- the plan of `ops/crf_dense.py` (`den_plan`), for every V up to MAX_V,
  N up to 64 and several cluster counts: every symbol owned exactly once,
  every utterance in one group, shared memory within the block's limit,
  the expW slice in shared memory exactly where it fits;
- a numpy model of the kernels' schedule at V = 9 and C = 2, 3, 4: each
  block a generator that runs the kernel's program on its own column
  slices and yields at each cluster barrier, the blocks run between two
  barriers one after another in a random order (so one block's writes
  for the next frame land before another block reads this frame's), and
  every exchange buffer is poisoned with NaN once read. Its snapshots,
  logZ and gradient rows are held against `den_forward_reference` and
  `den_backward_reference` to 1e-5 relative (gradient rows 1e-5 +
  1e-5·|plain|): the model computes in f32 in the kernels' order, not
  the plain versions'.
"""
import numpy as np
import pytest
import torch

from cat_tpu_torch.fst.ngram import train_ngram
from cat_tpu_torch.ops import crf_dense
from cat_tpu_torch.ops.crf_dense import (MAX_V, SMEM_LIMIT, DenseDen,
                                         den_plan, owned, owner)

LOG_EPS = np.float32(crf_dense.LOG_EPS)
F32 = np.float32


@pytest.mark.parametrize("clusters", [1, 7, 8, 16])
@pytest.mark.parametrize("backward", [False, True])
def test_plan(clusters, backward):
    rng = np.random.default_rng(clusters)
    for V in range(1, MAX_V + 1):
        C = crf_dense.cluster_size(V)
        assert 1 <= C <= min(V, crf_dense.MAX_CLUSTER)
        # every symbol owned exactly once, floor or ceil(V / C) a block
        seen = []
        for j in range(C):
            lo, hi = owned(V, C, j)
            assert hi - lo in (V // C, -(-V // C))
            seen += range(lo, hi)
            assert all(owner(V, C, u) == (j, u - lo) for u in range(lo, hi))
        assert seen == list(range(V))
        fits = crf_dense._smem_bytes(V, C, 1, True, backward) <= SMEM_LIMIT
        for N in range(1, 65):
            lens = torch.from_numpy(rng.integers(0, 500, N))
            plan = den_plan(lens, V, clusters, backward)
            assert (plan.C, plan.S) == (C, -(-V // C))
            assert plan.w_smem == fits
            assert plan.smem_bytes <= SMEM_LIMIT
            assert 1 <= plan.G <= crf_dense.MAX_GROUP
            if -(-N // clusters) <= plan.G:
                assert plan.groups <= clusters
            order = plan.order.tolist()
            groups = [order[k * plan.G:(k + 1) * plan.G]
                      for k in range(plan.groups)]
            assert len(groups) == plan.groups == -(-N // plan.G)
            flat = [n for grp in groups for n in grp]
            assert sorted(flat) == list(range(N))
            # longest first, so a group runs to its own longest utterance
            assert all(lens[a] >= lens[b] for a, b in zip(flat, flat[1:]))


def test_plan_at_the_training_batch():
    """crf-v1: V = 72, N = 32: C = 16, expW slice in shared memory, G
    fills the clusters the card holds (7 or 8 of 16 blocks)."""
    lens = torch.tensor([299 + 6 * k for k in range(32)])
    for backward in (False, True):
        for clusters, G in ((8, 4), (7, 5)):
            plan = den_plan(lens, 72, clusters, backward)
            assert (plan.C, plan.S, plan.G, plan.w_smem) == (16, 5, G, True)
            assert plan.order[:G].tolist() == [31, 30, 29, 28, 27][:G]
    # V = 96 keeps the same layout with the slice read from L2
    assert not den_plan(lens, MAX_V, 8, True).w_smem


# ---- the numpy model of the kernels' schedule ----

def _lae(a, b):
    m = np.maximum(a, b)
    with np.errstate(over="ignore", invalid="ignore"):
        out = m + np.log(np.exp(a - m) + np.exp(b - m))
    return np.where(m <= LOG_EPS / 2, LOG_EPS, out).astype(F32)


def _from_sum(m, s):
    return np.where(s <= 0, LOG_EPS,
                    m + np.log(np.maximum(s, F32(1e-37)))).astype(F32)


def _post(x):
    with np.errstate(over="ignore"):
        return np.where(x <= LOG_EPS / 2, F32(0), np.exp(x)).astype(F32)


def _run(blocks, rng):
    """Runs generator blocks barrier to barrier, each stretch between two
    barriers block after block in a random order."""
    while True:
        done = [next(blocks[j], "done") for j in rng.permutation(len(blocks))]
        if all(d == "done" for d in done):
            return
        assert "done" not in done, "blocks disagree on the barrier count"


class _Cluster:
    """One cluster's G utterances over C blocks: every block's shared
    memory, as the kernels lay it out by column slice."""

    def __init__(self, lp, lens, den, C, G, group):
        self.lp, self.den, self.C, self.G = lp, den, C, G
        N, self.T, self.V = lp.shape
        self.S = -(-self.V // C)
        self.un = list(group) + [-1] * (G - len(group))
        self.ul = np.array([lens[n] if n >= 0 else 0 for n in self.un])
        self.Tg = int(self.ul.max())
        self.expw = np.exp(np.maximum(den.logw, LOG_EPS)).astype(F32)
        self.sh = []
        for j in range(C):
            lo, hi = owned(self.V, C, j)
            nb = hi - lo
            abl = np.full((G, self.V, nb), LOG_EPS, F32)
            if lo == 0 and nb:
                abl[:, 0, 0] = 0
            self.sh.append(dict(
                lo=lo, nb=nb, ain=np.full((G, self.V, nb), LOG_EPS, F32),
                abl=abl, ex=np.full(2 * G * self.V * self.S, np.nan, F32),
                part=np.full((2, G), np.nan, F32),
                p=np.full((2, 2, G, self.V, nb), np.nan, F32),
                m=np.full((2, 2, G, nb), np.nan, F32)))

    def y(self, t):
        return np.stack([self.lp[n, t] if n >= 0 else np.zeros(self.V, F32)
                         for n in self.un])

    def prime(self, j, par):
        """Column maxima and exp-domain products of the own columns, for
        the frame of parity `par` (`column_products`)."""
        me = self.sh[j]
        src = np.stack([me["abl"], me["ain"]])            # (2, G, x, s)
        m = np.maximum(src.max(axis=2, initial=LOG_EPS), LOG_EPS)
        me["m"][par], me["p"][par] = m, np.exp(src - m[:, :, None, :])

    def alpha_frame(self, j, t, xpar, scr=None):
        """`alpha_frame`: rows b in B_j of emit0 from the products of
        parity t & 1, scattered to the owners of u; a_bl' (no emit0
        needed); barrier; a_in' from emit0 received; the products of the
        next frame into parity (t + 1) & 1."""
        me, V, G, S = self.sh[j], self.V, self.G, self.S
        lo, nb, par = me["lo"], me["nb"], t & 1
        m, p = me["m"][par], me["p"][par]
        assert not np.isnan(p).any(), "products of another frame"
        acc = np.zeros((2, G, nb, V), F32)                # rows b, cols u
        for a in range(V):
            acc += p[:, :, a, :, None] * self.expw[a, lo:lo + nb][None, None]
        mb, mi = m[0][:, :, None], m[1][:, :, None]
        M = np.maximum(mb, mi)
        with np.errstate(under="ignore"):
            v = acc[0] * np.exp(mb - M) + acc[1] * np.exp(mi - M)
            e0 = np.where(v > 0, M + np.log(np.where(v > 0, v, 1)),
                          _lae(_from_sum(mb, acc[0]), _from_sum(mi, acc[1])))
        for s in range(nb):
            e0[:, s, lo + s] = _from_sum(mb[:, s, 0], acc[0][:, s, lo + s])
        for u in range(V):
            r, su = owner(V, self.C, u)
            ex = self.sh[r]["ex"].reshape(2, G, V, S)
            ex[xpar, :, lo:lo + nb, su] = e0[:, :, u].astype(F32)
        me["p"][par] = np.nan
        ai, ab = me["ain"].copy(), me["abl"].copy()
        y = self.y(t)
        yu, y0 = y[:, None, lo:lo + nb], y[:, 0, None, None]
        act = (t < self.ul)[:, None, None]
        me["abl"] = np.where(act, np.maximum(_lae(ai, ab) + y0, LOG_EPS), ab)
        yield "barrier"
        ex = me["ex"].reshape(2, G, V, S)[xpar][:, :, :nb].copy()
        assert not np.isnan(ex).any(), "emit0 read before it was written"
        me["ex"].reshape(2, G, V, S)[xpar] = np.nan
        if scr is not None:
            scr[t] = (ai, ab, ex)
        me["ain"] = np.where(act, np.maximum(_lae(ai + yu, ex + yu),
                                             LOG_EPS), ai)
        self.prime(j, par ^ 1)

    def forward_block(self, j, snaps, logz):
        me, K = self.sh[j], self.den.ckpt_every
        lo, nb = me["lo"], me["nb"]
        self.prime(j, 0)
        yield "barrier"                                   # setup
        for t in range(self.T):
            if t % K == 0:
                for g, n in enumerate(self.un):
                    if n >= 0:
                        snaps[0][t // K, n, :, lo:lo + nb] = me["ain"][g]
                        snaps[1][t // K, n, :, lo:lo + nb] = me["abl"][g]
            if t < self.Tg:
                yield from self.alpha_frame(j, t, t & 1)
        fin = self.den.final[:, lo:lo + nb]
        pz = np.zeros((self.G, 2, 2), F32)
        for k, a in enumerate((me["ain"], me["abl"])):
            x = a + fin
            mx = np.maximum(x.max(axis=(1, 2), initial=LOG_EPS), LOG_EPS)
            pz[:, k] = np.stack([mx, np.exp(x - mx[:, None, None])
                                 .sum(axis=(1, 2))], axis=1)
        me["pz"] = pz
        yield "barrier"
        if j == 0:   # rank 0 combines the blocks' partials in rank order
            parts = np.stack([self.sh[r]["pz"] for r in range(self.C)])
            mx = np.maximum(parts[..., 0].max(axis=0), LOG_EPS)   # (G, 2)
            sm = np.zeros_like(mx)
            for r in range(self.C):
                sm += parts[r, ..., 1] * np.exp(parts[r, ..., 0] - mx)
            lse = _from_sum(mx, sm)
            for g, n in enumerate(self.un):
                if n >= 0:
                    logz[n] = _lae(lse[g, 0], lse[g, 1])
        yield "barrier"

    def beta_frame(self, j, t, par, pre, grad, lz, gn):
        """`beta_frame`: the own columns' gradient entries and blank
        parts, rhs scattered to the row owners; barrier; rank 0's blank
        entry, rows b in B_j of rhs contracted into E[:, b], the update."""
        me, V, G, S, C = self.sh[j], self.V, self.G, self.S, self.C
        lo, nb = me["lo"], me["nb"]
        ai, ab, e0 = pre
        y = self.y(t)
        yu, y0 = y[:, None, lo:lo + nb], y[:, 0, None, None]
        bi, bb = me["bin"], me["bbl"]
        s0 = (_post(ai + yu + bi - lz) + _post(e0 + yu + bi - lz)).sum(1)
        s1 = _post(_lae(ai, ab) + y0 + bb - lz).sum(1)    # (G, s)
        for g, n in enumerate(self.un):
            if t < self.ul[g]:
                for s in range(nb):
                    if lo + s > 0:
                        grad[n, t, lo + s] = s0[g, s] * gn[g]
        me["part"][par] = s1.sum(axis=1)
        for x in range(V):
            r, sx = owner(V, C, x)
            ex = self.sh[r]["ex"].reshape(2, G, S, V)
            ex[par, :, sx, lo:lo + nb] = yu[:, 0] + bi[:, x]
        yield "barrier"
        if j == 0:
            parts = [self.sh[r]["part"][par] for r in range(C)]
            assert not np.isnan(parts).any()
            for g, n in enumerate(self.un):
                total = F32(0)
                for r in range(C):
                    total += parts[r][g]
                if t < self.ul[g]:
                    grad[n, t, 0] = total * gn[g]
        rhs = me["ex"].reshape(2, G, S, V)[par][:, :nb].copy()  # rows b
        assert not np.isnan(rhs).any(), "rhs read before it was written"
        me["ex"].reshape(2, G, S, V)[par] = np.nan
        # a u that is no LM event after b takes no part in the shift
        rhs = np.where(self.den.emit[lo:lo + nb][None], rhs, LOG_EPS)
        nr = rhs.copy()
        for s in range(nb):
            nr[:, s, lo + s] = LOG_EPS
        ma = np.maximum(rhs.max(axis=2, initial=LOG_EPS), LOG_EPS)
        mn = np.maximum(nr.max(axis=2, initial=LOG_EPS), LOG_EPS)
        pa, pn = np.exp(rhs - ma[..., None]), np.exp(nr - mn[..., None])
        acc = np.zeros((2, G, V, nb), F32)                # (a, b) column
        for u in range(V):
            w = self.expw[:, lo:lo + nb, u][None]
            acc[0] += pa[:, None, :, u] * w
            acc[1] += pn[:, None, :, u] * w
        e_all = _from_sum(ma[:, None, :], acc[0])
        e_nr = _from_sum(mn[:, None, :], acc[1])
        stay, blank = yu + bi, y0 + bb
        act = (t < self.ul)[:, None, None]
        me["bin"] = np.where(act, np.maximum(_lae(_lae(stay, e_nr), blank),
                                             LOG_EPS), bi)
        me["bbl"] = np.where(act, np.maximum(_lae(e_all, blank), LOG_EPS), bb)

    def backward_block(self, j, snaps, logz, g, grad):
        me, K, V = self.sh[j], self.den.ckpt_every, self.V
        lo, nb = me["lo"], me["nb"]
        lz = np.array([0 if n < 0 or logz[n] <= LOG_EPS / 2 else logz[n]
                       for n in self.un], F32)[:, None, None]
        gn = np.array([g[n] if n >= 0 else 0 for n in self.un], F32)
        me["bin"] = np.repeat(self.den.final[None, :, lo:lo + nb], self.G, 0)
        me["bbl"] = me["bin"].copy()
        for gi, n in enumerate(self.un):
            if n >= 0:
                grad[n, self.ul[gi]:, lo:lo + nb] = 0
        yield "barrier"
        fc = 0
        for seg in range(-(-self.T // K) - 1, -1, -1):
            t0 = seg * K
            if t0 >= self.Tg:
                continue
            t1 = min(t0 + K, self.Tg)
            for k, key in enumerate(("ain", "abl")):
                me[key] = np.stack([
                    snaps[k][seg, n, :, lo:lo + nb] if n >= 0
                    else np.full((V, nb), LOG_EPS, F32) for n in self.un])
            self.prime(j, t0 & 1)
            scr = {}
            for t in range(t0, t1):
                yield from self.alpha_frame(j, t, fc & 1, scr)
                fc += 1
            for t in range(t1 - 1, t0 - 1, -1):
                yield from self.beta_frame(j, t, fc & 1, scr[t], grad, lz,
                                           gn)
                fc += 1
        yield "barrier"


def _inputs(seed=0, V=9, N=3, T=30, K=7):
    rng = np.random.default_rng(seed)
    seqs = [list(map(int, rng.integers(1, V, size=int(rng.integers(3, 30)))))
            for _ in range(200)]
    den = DenseDen.from_ngram(train_ngram(seqs, order=3), V)
    den = DenseDen(den.logw, den.final, ckpt_every=K)
    x = rng.standard_normal((N, T, V)).astype(F32) * 2
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(F32)
    lens = np.array([T, T - 11, 1][:N])
    return lp, lens, den


def _model(lp, lens, den, C, G, seed, backward_g=None, snaps=None,
           logz=None):
    """The kernels' forward (or, given `backward_g`, backward) on every
    cluster of the plan's grouping."""
    N, T, V = lp.shape
    S_T = -(-T // den.ckpt_every)
    order = np.argsort(-lens, kind="stable")
    rng = np.random.default_rng(seed)
    if backward_g is not None:
        out = np.full((N, T, V), np.nan, F32)
    else:
        out = ((np.full((S_T, N, V, V), np.nan, F32),
                np.full((S_T, N, V, V), np.nan, F32)), np.full(N, np.nan, F32))
    for k in range(-(-N // G)):
        cl = _Cluster(lp, lens, den, C, G, order[k * G:(k + 1) * G])
        if backward_g is None:
            blocks = [cl.forward_block(j, out[0], out[1]) for j in range(C)]
        else:
            blocks = [cl.backward_block(j, snaps, logz, backward_g, out)
                      for j in range(C)]
        _run(blocks, rng)
    return out


@pytest.mark.parametrize("C", [2, 3, 4])
def test_model_forward_matches_plain(C):
    lp, lens, den = _inputs()
    (m_in, m_bl), m_z = _model(lp, lens, den, C, 2, seed=C)
    (r_in, r_bl), r_z = crf_dense.den_forward_reference(
        torch.from_numpy(lp), torch.from_numpy(lens), den)
    np.testing.assert_allclose(m_z, r_z.numpy(), rtol=1e-5, atol=0)
    for got, want in ((m_in, r_in.numpy()), (m_bl, r_bl.numpy())):
        live = want > LOG_EPS / 2
        assert (got[~live] <= LOG_EPS / 2).all()
        np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=0)


@pytest.mark.parametrize("C", [2, 3, 4])
def test_model_backward_matches_plain(C):
    lp, lens, den = _inputs(seed=1)
    (r_in, r_bl), r_z = crf_dense.den_forward_reference(
        torch.from_numpy(lp), torch.from_numpy(lens), den)
    g = np.array([1.0, -0.5, 2.0], F32)
    snaps = (r_in.numpy(), r_bl.numpy())
    got = _model(lp, lens, den, C, 2, seed=10 + C, backward_g=g,
                 snaps=snaps, logz=r_z.numpy())
    want = crf_dense.den_backward_reference(
        torch.from_numpy(lp), torch.from_numpy(lens), (r_in, r_bl), r_z,
        torch.from_numpy(g), den).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_model_catches_a_single_exchange_buffer(monkeypatch):
    """The schedule's point: with one exchange buffer instead of two (both
    parities on one half), a block's next-frame writes reach another
    block before it reads the current frame, and the model fails."""
    lp, lens, den = _inputs()
    frame = _Cluster.alpha_frame
    monkeypatch.setattr(_Cluster, "alpha_frame",
                        lambda self, j, t, par, scr=None:
                        frame(self, j, t, 0, scr))
    with pytest.raises(AssertionError):
        (m_in, _), m_z = _model(lp, lens, den, 3, 2, seed=3)
        r_z = crf_dense.den_forward_reference(
            torch.from_numpy(lp), torch.from_numpy(lens), den)[1]
        np.testing.assert_allclose(m_z, r_z.numpy(), rtol=1e-5)


def test_backward_when_the_model_favours_a_unit_the_lm_never_emits():
    """A model that puts its mass on a unit the LM never saw (an untrained
    model and <unk>): y[u] + beta[b, u] is largest at that u in every row,
    where W is zero. Shifted there, the beta contraction flushed every
    other term to zero (or to a denormal, which log(max(s, 1e-37))
    lifted), and the gradient rows went to inf. Shifted over the LM's
    events, the posterior rows sum to 1 (1e-3), in the plain version and
    in the model of the kernel, which agree (1e-5 relative). The JAX
    package's rows on the same inputs are printed beside them."""
    rng = np.random.default_rng(3)
    V, T = 9, 90
    seqs = [list(map(int, rng.integers(2, V, size=int(rng.integers(3, 30)))))
            for _ in range(200)]  # unit 1 never occurs
    den = DenseDen.from_ngram(train_ngram(seqs, order=3), V)
    den = DenseDen(den.logw, den.final, ckpt_every=7)
    assert not den.emit[:, 1].any() and not den.emit[:, 0].any()
    x = rng.standard_normal((3, T, V)).astype(F32)
    x[..., 1] += 9.0
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(F32)
    lens = np.array([T, T - 13, 40])
    (r_in, r_bl), r_z = crf_dense.den_forward_reference(
        torch.from_numpy(lp), torch.from_numpy(lens), den)
    g = np.ones(3, F32)
    want = crf_dense.den_backward_reference(
        torch.from_numpy(lp), torch.from_numpy(lens), (r_in, r_bl), r_z,
        torch.from_numpy(g), den).numpy()
    assert np.isfinite(want).all()
    for n, L in enumerate(lens):
        np.testing.assert_allclose(want[n, :L].sum(-1), 1.0, atol=1e-3)
    got = _model(lp, lens, den, 3, 2, seed=5, backward_g=g,
                 snaps=(r_in.numpy(), r_bl.numpy()), logz=r_z.numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the JAX package's den backward shifts at the same u (ROADMAP.md §C,
    # caveat 8): its rows, printed, do not sum to 1 here
    import jax
    import jax.numpy as jnp

    from cat_tpu.ops import crf_dense as jax_crf_dense
    jden = jax_crf_dense.DenseDen(den.logw, den.final, ckpt_every=7)
    jg = np.asarray(jax.grad(lambda a: jax_crf_dense.dense_den_log_partition(
        a, jnp.asarray(lens, np.int32), jden).sum())(jnp.asarray(lp)))
    rows = np.concatenate([jg[n, :L].sum(-1) for n, L in enumerate(lens)])
    ours = np.concatenate([want[n, :L].sum(-1) for n, L in enumerate(lens)])
    print(f"posterior row sums: port {ours.min():.6g}..{ours.max():.6g}, "
          f"JAX {rows.min():.3g}..{rows.max():.3g}")
