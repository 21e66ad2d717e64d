"""Port parity for the RNN-T losses, in float32 on the CPU.

- The lattice recursions' plain versions (`forward_alphas_reference`,
  `backward_betas_reference`, what a CPU tensor takes) against the JAX
  package's Pallas kernels in interpret mode (`forward_alphas_pallas`,
  `backward_betas_pallas`) and its `lax.scan` path, on ragged lengths
  with a label length of 0, an utterance of one frame, U+1 of 1 and T of
  1; the tables (`_row_tables`) against JAX's.
- `rnnt_loss`: value and gradient against JAX's `rnnt_loss` with
  `CAT_TPU_RNNT_IMPL=pallas` (so JAX runs its two kernels in interpret
  mode), for every reduction.
- `rnnt_loss_simple`: value and the gradients with respect to f and g
  against JAX's, on its Pallas route too.
Tolerance: rtol 1e-4, atol 1e-4 on states, losses and gradients; states
at or below LOG_EPS / 2 must be so on both sides.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ops import rnnt as jax_rnnt
from cat_tpu.ops.rnnt_pallas import (backward_betas_pallas,
                                     forward_alphas_pallas)
from cat_tpu.ops.rnnt_simple import rnnt_loss_simple as jax_loss_simple
from cat_tpu_torch.ops import rnnt, rnnt_simple
from cat_tpu_torch.ops.semiring import LOG_EPS

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
# (N, T, U, V, input lengths, label lengths)
CASES = {
    "ragged": (4, 11, 5, 7, [11, 9, 1, 6], [5, 3, 0, 2]),
    "one frame": (2, 1, 3, 5, [1, 1], [3, 0]),
    "no labels": (2, 6, 0, 4, [6, 4], [0, 0]),
    "wide": (2, 5, 40, 9, [5, 3], [40, 17]),
}


def _case(name, seed=0):
    N, T, U, V, ilens, llens = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, T, U + 1, V)).astype(np.float32) * 2
    lp = np.array(jax.nn.log_softmax(x, -1))
    labels = rng.integers(1, V, (N, U)).astype(np.int32)
    labels *= np.arange(U)[None, :] < np.array(llens)[:, None]
    return lp, labels, np.array(ilens, np.int32), np.array(llens, np.int32)


def _states(got, want):
    got, want = np.asarray(got), np.asarray(want)
    live = want > LOG_EPS / 2
    assert (got[~live] <= LOG_EPS / 2).all()
    np.testing.assert_allclose(got[live], want[live], **TOL)


def _torch_tables(lp, labels, ilens, llens):
    return rnnt._row_tables(torch.from_numpy(lp), torch.from_numpy(labels),
                            torch.from_numpy(ilens).long(),
                            torch.from_numpy(llens).long(), 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_row_tables_match_jax(name):
    lp, labels, ilens, llens = _case(name)
    got = _torch_tables(lp, labels, ilens, llens)
    want = jax_rnnt._row_tables(jnp.asarray(lp), jnp.asarray(labels),
                                jnp.asarray(ilens), jnp.asarray(llens), 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", sorted(CASES))
def test_alphas_and_betas_match_pallas_and_scan(name):
    lp, labels, ilens, llens = _case(name, seed=1)
    be, le, _, _ = _torch_tables(lp, labels, ilens, llens)
    jbe, jle = jnp.asarray(be.numpy()), jnp.asarray(le.numpy())
    alphas = rnnt.forward_alphas_reference(be, le)
    _states(alphas, forward_alphas_pallas(jbe, jle, interpret=True))
    _states(alphas, jax_rnnt._forward_alphas(jbe, jle))
    term = rnnt.beta_term(torch.from_numpy(llens).long(), be.shape[2])
    want_b, want_term = jax_rnnt._backward_betas(jbe, jle, jnp.asarray(llens))
    np.testing.assert_array_equal(term.numpy(), np.asarray(want_term))
    betas = rnnt.backward_betas_reference(be, le, term)
    _states(betas, backward_betas_pallas(jbe, jle, want_term, interpret=True))
    _states(betas, want_b)
    # a CPU tensor takes the plain versions and launches nothing
    before = (rnnt.forward_alphas.launches, rnnt.backward_betas.launches)
    assert torch.equal(rnnt.forward_alphas(be, le), alphas)
    assert torch.equal(rnnt.backward_betas(be, le, term), betas)
    assert (rnnt.forward_alphas.launches,
            rnnt.backward_betas.launches) == before


@pytest.fixture
def pallas_rnnt(monkeypatch):
    monkeypatch.setenv("CAT_TPU_RNNT_IMPL", "pallas")
    assert jax_rnnt._use_pallas()


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_rnnt_loss_matches_jax(pallas_rnnt, reduction):
    lp, labels, ilens, llens = _case("ragged", seed=2)
    w = np.random.default_rng(3).uniform(0.5, 2.0, lp.shape[0])

    def jax_loss(x):
        nll = jax_rnnt.rnnt_loss(x, labels, ilens, llens,
                                 reduction=reduction)
        return jnp.sum(nll * w) if reduction == "none" else nll

    want, want_g = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_()
    nll = rnnt.rnnt_loss(x, torch.from_numpy(labels), torch.from_numpy(ilens),
                         torch.from_numpy(llens), reduction=reduction)
    if reduction == "none":
        assert nll.shape == (lp.shape[0],)
        assert torch.isfinite(nll).all()
        nll = (nll * torch.from_numpy(w).float()).sum()
    nll.backward()
    np.testing.assert_allclose(nll.item(), float(want), rtol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), **TOL)


@pytest.mark.parametrize("name", ["ragged", "one frame", "wide"])
def test_rnnt_loss_simple_matches_jax(pallas_rnnt, name):
    N, T, U, V, ilens, llens = CASES[name]
    rng = np.random.default_rng(4)
    f = rng.standard_normal((N, T, V)).astype(np.float32) * 2
    g = rng.standard_normal((N, U + 1, V)).astype(np.float32) * 2
    labels = rng.integers(1, V, (N, U)).astype(np.int32)
    labels *= np.arange(U)[None, :] < np.array(llens)[:, None]
    ilens, llens = np.array(ilens, np.int32), np.array(llens, np.int32)

    def jax_loss(f, g):
        return jax_loss_simple(f, g, labels, ilens, llens, reduction="sum")

    want, (want_f, want_g) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1)))(jnp.asarray(f), jnp.asarray(g))
    tf = torch.from_numpy(f).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    loss = rnnt_simple.rnnt_loss_simple(
        tf, tg, torch.from_numpy(labels), torch.from_numpy(ilens),
        torch.from_numpy(llens), reduction="sum")
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_f), **TOL)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(want_g), **TOL)
