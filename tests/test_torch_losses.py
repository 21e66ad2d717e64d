"""Port parity for the training losses and SpecAugment, in float32 on the
CPU: `cat_tpu_torch.ops.ctc`, `ops.crf_dense`, `fst.ngram`, `ops.specaug`
against their `cat_tpu` counterparts (the XLA scan paths, and the Pallas
routes in interpret mode) on the same numpy inputs, and CTC also against
`torch.nn.functional.ctc_loss`.

The plain versions of the loss kernels against the TPU kernels they
stand for: `forward_alphas_reference` / `backward_betas_reference` against
`forward_alphas_pallas` / `backward_betas_pallas`, `den_forward_reference`
against `dense_den_forward_pallas`, `den_backward_reference` against the
VJP of `dense_den_log_partition` with the fused den on. The fused den
needs `CAT_TPU_PARTITIONED=0` here: under the 8 virtual devices of
`tests/conftest.py` the JAX package would otherwise route around it.

Tolerances: loss values and gradients rtol 1e-4, atol 1e-4 against JAX
and torch (the same recursions in another order); lattice states and
snapshots rtol 1e-5, atol 1e-4 where live (above LOG_EPS / 2), and at or
below LOG_EPS / 2 on both sides elsewhere; dense tables equal to rtol
1e-6; the n-gram LM and SpecAugment with the same masks exactly equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.fst.ngram import train_ngram as jax_train_ngram
from cat_tpu.ops.crf_dense import DenseDen as JaxDenseDen
from cat_tpu.ops.crf_dense import \
    dense_den_log_partition as jax_den_log_partition
from cat_tpu.ops.crf_dense_pallas import dense_den_forward_pallas
from cat_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from cat_tpu.ops.ctc_pallas import (backward_betas_pallas,
                                    forward_alphas_pallas)
from cat_tpu.ops.specaug import specaug as jax_specaug
from cat_tpu_torch.fst.ngram import train_ngram
from cat_tpu_torch.ops import ctc as ctc_op
from cat_tpu_torch.ops import specaug
from cat_tpu_torch.ops.crf_dense import (DenseDen, den_backward_reference,
                                         den_forward_reference,
                                         dense_den_log_partition)
from cat_tpu_torch.ops.ctc import ctc_loss
from cat_tpu_torch.ops.semiring import LOG_EPS

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _log_probs(N, T, V, seed, scale=2.0):
    x = np.random.default_rng(seed).standard_normal((N, T, V)) * scale
    return np.array(jax.nn.log_softmax(x.astype(np.float32), -1))


def _ctc_case(seed=0, llens=(6, 4, 3, 1)):
    rng = np.random.default_rng(seed)
    N, T, V, U = 4, 23, 7, 6
    lp = _log_probs(N, T, V, seed)
    ilens = np.array([23, 17, 9, 1])
    llens = np.array(llens)
    labels = rng.integers(1, V, (N, U))
    labels[1, :2] = 5                      # a repeat: the skip is barred
    labels *= np.arange(U)[None, :] < llens[:, None]
    return lp, labels.astype(np.int32), ilens.astype(np.int32), \
        llens.astype(np.int32)


def test_ctc_matches_jax():
    lp, labels, ilens, llens = _ctc_case()
    g = np.random.default_rng(9).standard_normal(lp.shape[0]).astype(
        np.float32)
    want, vjp = jax.vjp(lambda x: jax_ctc_loss(x, labels, ilens, llens,
                                               reduction="none"),
                        jnp.asarray(lp))
    lpt = torch.from_numpy(lp).requires_grad_()
    got = ctc_loss(lpt, torch.from_numpy(labels), torch.from_numpy(ilens),
                   torch.from_numpy(llens), reduction="none")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(lpt.grad.numpy(), np.asarray(vjp(g)[0]),
                               **TOL)


def _assert_states_close(got, want):
    """Live states (above LOG_EPS / 2) to rtol 1e-5, atol 1e-4; the rest
    at or below LOG_EPS / 2 on both sides."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    live = want > LOG_EPS / 2
    assert (got[~live] <= LOG_EPS / 2).all()
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-4)
    return live.mean()


# a repeated label (the skip is barred), U_n = 0 and T_n = 1
LATTICE_CASE = dict(seed=2, llens=(6, 4, 0, 1))


def _lattice_inputs():
    """em (T, N, S), allow2, allow2_dst (N, S) bool and beta_last (N, S)
    of the CTC case, as the port's `_CTCNll` builds them."""
    lp, labels, ilens, llens = _ctc_case(**LATTICE_CASE)
    labels, llens = torch.from_numpy(labels).long(), \
        torch.from_numpy(llens).long()
    S = 2 * labels.shape[1] + 1
    ext, svalid, allow2 = ctc_op._lattice_tables(labels, llens, 0, S)
    em = ctc_op._emissions(torch.from_numpy(lp), ext, svalid,
                           torch.from_numpy(ilens).long(), 0)
    allow2_dst, beta_last = ctc_op._beta_tables(allow2, llens)
    return em, allow2, allow2_dst, beta_last


def test_ctc_alphas_match_pallas_kernel():
    em, allow2, _, _ = _lattice_inputs()
    want = forward_alphas_pallas(jnp.asarray(em.numpy()),
                                 jnp.asarray(allow2.numpy()), interpret=True)
    got = ctc_op.forward_alphas_reference(em, allow2)
    assert 0.05 < _assert_states_close(got.numpy(), want) < 1.0


def test_ctc_betas_match_pallas_kernel():
    em, _, allow2_dst, beta_last = _lattice_inputs()
    want = backward_betas_pallas(jnp.asarray(em.numpy()),
                                 jnp.asarray(allow2_dst.numpy()),
                                 jnp.asarray(beta_last.numpy()),
                                 interpret=True)
    got = ctc_op.backward_betas_reference(em, allow2_dst, beta_last)
    assert 0.05 < _assert_states_close(got.numpy(), want) < 1.0


def test_ctc_matches_jax_pallas_route(monkeypatch):
    """The port's CTC loss and gradient against JAX's with the Pallas
    alpha/beta kernels (interpret mode), on the lattice case."""
    monkeypatch.setenv("CAT_TPU_CTC_IMPL", "pallas")
    lp, labels, ilens, llens = _ctc_case(**LATTICE_CASE)
    g = np.random.default_rng(3).standard_normal(lp.shape[0]).astype(
        np.float32)
    want, vjp = jax.vjp(lambda x: jax_ctc_loss(x, labels, ilens, llens,
                                               reduction="none"),
                        jnp.asarray(lp))
    lpt = torch.from_numpy(lp).requires_grad_()
    got = ctc_loss(lpt, torch.from_numpy(labels), torch.from_numpy(ilens),
                   torch.from_numpy(llens), reduction="none")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(lpt.grad.numpy(), np.asarray(vjp(g)[0]),
                               **TOL)


def test_ctc_matches_torch_ctc_loss():
    lp, labels, ilens, llens = _ctc_case(seed=1)
    lpt = torch.from_numpy(lp).requires_grad_()
    got = ctc_loss(lpt, torch.from_numpy(labels), torch.from_numpy(ilens),
                   torch.from_numpy(llens), reduction="sum")
    ref_in = torch.from_numpy(lp).requires_grad_()
    want = torch.nn.functional.ctc_loss(
        ref_in.transpose(0, 1), torch.from_numpy(labels).long(),
        torch.from_numpy(ilens).long(), torch.from_numpy(llens).long(),
        blank=0, reduction="sum", zero_infinity=False)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
    got.backward()
    want.backward()
    # torch's ctc_loss returns the gradient through a log-softmax of its
    # input, exp(log_probs) - posterior, on the valid frames; the port's
    # (and JAX's) is d/d(log_probs) itself, -posterior
    valid = np.arange(lp.shape[1])[None, :] < ilens[:, None]
    np.testing.assert_allclose((lpt.grad.numpy() + np.exp(lp))[valid],
                               ref_in.grad.numpy()[valid], rtol=1e-4,
                               atol=1e-4)


def _lm_and_tables(V, order=3, seed=0):
    rng = np.random.default_rng(seed)
    seqs = [list(map(int, rng.integers(1, V, size=int(rng.integers(3, 12)))))
            for _ in range(60)]
    return (DenseDen.from_ngram(train_ngram(seqs, order=order), V),
            JaxDenseDen.from_ngram(jax_train_ngram(seqs, order=order), V))


def test_ngram_matches_jax():
    rng = np.random.default_rng(2)
    seqs = [list(map(int, rng.integers(1, 9, size=int(rng.integers(2, 9)))))
            for _ in range(40)]
    port, ref = train_ngram(seqs, order=3), jax_train_ngram(seqs, order=3)
    assert port.probs == ref.probs and port.bows == ref.bows
    for ctx, w in [((), 3), ((5,), 2), ((1, 2), 7), ((8, 8), 1),
                   (("<s>", "<s>"), 4), ((3, 4), "</s>")]:
        assert port.logp(ctx, w) == ref.logp(ctx, w)


@pytest.mark.parametrize("order", [2, 3])
def test_dense_tables_match_jax(order):
    port, ref = _lm_and_tables(9, order)
    np.testing.assert_allclose(port.logw, np.asarray(ref.logw), rtol=1e-6)
    np.testing.assert_allclose(port.final, np.asarray(ref.final), rtol=1e-6)


def test_dense_den_matches_jax(tmp_path):
    """T = 50: two full 24-frame segments and a partial one."""
    V, N, T = 9, 3, 50
    port, ref = _lm_and_tables(V)
    port.save(tmp_path / "den.npz")
    port = DenseDen.load(tmp_path / "den.npz")
    lp = _log_probs(N, T, V, seed=4)
    ilens = np.array([50, 31, 7], np.int32)
    g = np.array([1.0, -0.5, 2.0], np.float32)
    want, vjp = jax.vjp(lambda x: jax_den_log_partition(x, ilens, ref),
                        jnp.asarray(lp))
    lpt = torch.from_numpy(lp).requires_grad_()
    got = dense_den_log_partition(lpt, torch.from_numpy(ilens), port)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(lpt.grad.numpy(), np.asarray(vjp(g)[0]),
                               **TOL)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_den_forward_matches_pallas_kernel(order):
    """Snapshots and logZ of the plain den forward against the TPU
    kernel's (interpret mode): T = 53 is two full 24-frame segments and a
    partial one; one utterance has a single frame."""
    V, N, T = 9, 3, 53
    port, ref = _lm_and_tables(V, order)
    # logits of unit scale: the TPU kernel's exp-domain snapshots floor
    # states more than ~87 nats below their utterance's maximum (ROADMAP.md,
    # reference caveat 2), which peakier log-probs reach at this depth
    lp = _log_probs(N, T, V, seed=5, scale=1.0)
    ilens = np.array([53, 30, 1], np.int32)
    (want_in, want_bl), want_z = dense_den_forward_pallas(
        jnp.asarray(lp), jnp.asarray(ilens), ref, interpret=True)
    (got_in, got_bl), got_z = den_forward_reference(
        torch.from_numpy(lp), torch.from_numpy(ilens).long(), port)
    assert got_in.shape == (3, N, V, V)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), rtol=1e-5,
                               atol=1e-4)
    for got, want in ((got_in, want_in), (got_bl, want_bl)):
        assert _assert_states_close(got, want) > 0.01


def test_den_backward_matches_jax_fused_route(monkeypatch):
    """The plain den backward, fed the plain forward's snapshots, against
    the VJP of JAX's fused-den route (Pallas forward in interpret mode,
    XLA backward)."""
    monkeypatch.setenv("CAT_TPU_FUSED_DEN", "1")
    monkeypatch.setenv("CAT_TPU_PARTITIONED", "0")
    from cat_tpu.ops.crf_dense import _use_pallas_den
    assert _use_pallas_den()
    V, N, T = 9, 3, 53
    port, ref = _lm_and_tables(V)
    lp = _log_probs(N, T, V, seed=6)
    ilens = np.array([53, 30, 1], np.int32)
    g = np.array([1.0, -0.5, 2.0], np.float32)
    want_z, vjp = jax.vjp(lambda x: jax_den_log_partition(x, ilens, ref),
                          jnp.asarray(lp))
    lpt, lens = torch.from_numpy(lp), torch.from_numpy(ilens).long()
    snaps, logz = den_forward_reference(lpt, lens, port)
    np.testing.assert_allclose(logz.numpy(), np.asarray(want_z), **TOL)
    got = den_backward_reference(lpt, lens, snaps, logz,
                                 torch.from_numpy(g), port)
    assert got.shape == (N, T, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(g)[0]), **TOL)
    assert (got[2, 1:] == 0).all() and (got[1, 30:] == 0).all()


def _jax_masks(key, lengths, F, cfg):
    """The masks jax_specaug draws from `key`, by its own key splits."""
    N = lengths.shape[0]
    k_f, k_t, _ = jax.random.split(key, 3)
    kw, ks = jax.random.split(k_f, 2)
    fw = jax.random.randint(kw, (N, cfg["num_freq_masks"]), 0,
                            min(cfg["freq_mask_width"], F) + 1)
    fs = (jax.random.uniform(ks, fw.shape) * jnp.maximum(F - fw, 1)
          ).astype(jnp.int32)
    k1, k2 = jax.random.split(k_t)
    cap = jnp.minimum(cfg["time_mask_width"],
                      (jnp.asarray(lengths, jnp.float32) * 0.2)
                      .astype(jnp.int32))
    tw = (jax.random.uniform(k1, (N, cfg["num_time_masks"]))
          * (cap[:, None] + 1)).astype(jnp.int32)
    ts = (jax.random.uniform(k2, tw.shape)
          * jnp.maximum(jnp.asarray(lengths)[:, None] - tw, 1)
          ).astype(jnp.int32)
    t = lambda a: torch.from_numpy(np.array(a)).long()
    return {"freq_starts": t(fs), "freq_widths": t(fw),
            "time_starts": t(ts), "time_widths": t(tw)}


def test_specaug_with_given_masks_matches_jax():
    cfg = dict(num_freq_masks=2, freq_mask_width=27, num_time_masks=2,
               time_mask_width=100)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 210, 80)).astype(np.float32)
    lengths = np.array([210, 150, 40], np.int32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_specaug(key, jnp.asarray(feats),
                                  jnp.asarray(lengths), **cfg))
    got = specaug.apply_masks(torch.from_numpy(feats),
                              _jax_masks(key, lengths, 80, cfg))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()


def test_specaug_draws_within_bounds():
    gen = torch.Generator().manual_seed(0)
    lengths = torch.tensor([400, 100, 6])
    m = specaug.draw_masks(gen, lengths, 80)
    cap = torch.clamp_max((lengths.float() * 0.2).long(), 100)
    assert (m["time_widths"] <= cap[:, None]).all()
    assert (m["time_starts"] < torch.clamp_min(lengths, 1)[:, None]).all()
    assert (m["freq_widths"] <= 27).all()
    assert (m["freq_starts"] + m["freq_widths"] <= 80 + 27).all()
    again = specaug.draw_masks(torch.Generator().manual_seed(0), lengths, 80)
    assert all(torch.equal(m[k], again[k]) for k in m)


def test_train_loss_draws_specaug_masks_first_from_its_generator():
    """The train loss applies SpecAugment with the first draws of the
    generator it is given, so the masks of a step can be drawn again from
    a generator of the same seed (chip_smoke.py finds the time-masked
    frames of its train step so)."""
    from cat_tpu_torch.ctc.train import make_loss_fn
    cfg = dict(num_freq_masks=2, freq_mask_width=27, num_time_masks=2,
               time_mask_width=100)
    seen = {}

    class Probe(torch.nn.Module):
        def forward(self, x, lengths, gen=None):
            seen["feats"] = x
            return torch.zeros(x.shape[0], x.shape[1], 5), lengths

    feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 120, 80)).astype(np.float32))
    lengths = torch.tensor([120, 90])
    batch = {"feats": feats, "feat_lengths": lengths,
             "labels": torch.tensor([[1, 2], [3, 0]]),
             "label_lengths": torch.tensor([2, 1]), "weight": torch.ones(2)}
    loss, _ = make_loss_fn(Probe(), "ctc", specaug_cfg=cfg)(
        batch, torch.Generator().manual_seed(5), True)
    want = specaug.apply_masks(feats, specaug.draw_masks(
        torch.Generator().manual_seed(5), lengths, 80, **cfg))
    assert torch.isfinite(loss)
    assert (want == 0).any() and not (feats == 0).any()
    assert torch.equal(seen["feats"], want)
