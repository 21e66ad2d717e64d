"""The port's Philox keep-mask (`cat_tpu_torch.ops.dropout`), the plain twin
of the CUDA kernels' mask (`csrc/common.cuh`), and the standalone dropout
op.

Checks: Random123's known-answer vectors for Philox-4x32-10; the mask is a
pure function of (seed, stream, plane, row, column), so any slice of a
larger mask is the mask of that slice, a new seed or stream gives another
mask, and the same call gives the same mask; the keep rate at 0.1 is
within 5 binomial standard deviations of 0.9; the train-mode `Dropout`
module draws its seeds from the generator it is handed. The `dropout` op
applies one mask forward and backward and is the identity, calling no
kernel wrapper, at rate 0 and in eval mode. Against JAX's `fused_dropout`
(interpret mode), whose TPU bits cannot be matched (ROADMAP.md, reference
caveat 3): equal at rate 0, and both hold the same contract at rate > 0
(values 0 or x / (1 - p), keep rate within binomial bounds, one mask per
seed).
"""
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cat_tpu.ops.dropout_pallas import fused_dropout
from cat_tpu_torch.models.layers import Dropout
from cat_tpu_torch.ops import dropout


def test_philox_known_answers():
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        got = dropout.philox4x32_10(*map(t, ctr), *key)
        assert tuple(int(w) for w in got) == want


def test_mask_is_a_pure_function_of_its_coordinates():
    seed = (1234, 0xDEADBEEF)
    big = dropout.keep_mask(seed, 0, 3, 40, 70, 0.1)
    assert torch.equal(big, dropout.keep_mask(seed, 0, 3, 40, 70, 0.1))
    # a smaller call is the corner of the bigger one, whatever the tiling
    assert torch.equal(big[:2, :17, :33],
                       dropout.keep_mask(seed, 0, 2, 17, 33, 0.1))
    assert not torch.equal(big, dropout.keep_mask(seed, 1, 3, 40, 70, 0.1))
    assert not torch.equal(big, dropout.keep_mask((1235, 0xDEADBEEF), 0, 3,
                                                  40, 70, 0.1))
    assert dropout.keep_mask(seed, 0, 1, 5, 5, 0.0).all()


def test_keep_rate_within_binomial_bounds():
    n = 1000 * 1024
    keep = dropout.keep_mask((7, 11), 0, 1, 1000, 1024, 0.1).float().mean()
    sigma = (0.1 * 0.9 / n) ** 0.5
    assert abs(keep.item() - 0.9) < 5 * sigma
    assert dropout.threshold(0.1) == 429496729


def test_dropout_module_draws_from_its_generator():
    layer = Dropout(0.1).train()
    x = torch.ones(4, 6, 32)
    a = layer(x, torch.Generator().manual_seed(5))
    b = layer(x, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) <= {0.0, torch.tensor(1.0 / 0.9).item()}
    assert torch.equal(layer.eval()(x), x)


def test_dropout_op_applies_one_mask_forward_and_backward():
    seed = (99, 0xABCDEF01)
    x = torch.randn(3, 7, 510, dtype=torch.float64).float().requires_grad_()
    y = dropout.dropout(x, 0.25, seed)
    scale = dropout.dropout_scale(seed, 0, 1, 21, 510, 0.25)[0].view(x.shape)
    assert torch.equal(y, x * scale)
    g = torch.randn(3, 7, 510)
    y.backward(g)
    assert torch.equal(x.grad, g * scale)
    assert 0 < (scale == 0).float().mean() < 0.5


@pytest.mark.parametrize("how", ["rate 0", "eval"])
def test_dropout_is_the_identity_without_a_launch(how):
    x = torch.randn(2, 5, 16)
    layer = Dropout(0.0 if how == "rate 0" else 0.1)
    layer.train(how == "rate 0")
    with mock.patch.object(dropout, "dropout_apply",
                           side_effect=AssertionError("called")):
        assert layer(x, torch.Generator().manual_seed(0)) is x
        assert dropout.dropout(x, 0.0, None) is x


def _contract(out, x, rate):
    """Values 0 or x / (1 - rate); the keep rate within 5 binomial
    standard deviations of 1 - rate."""
    out, x = np.asarray(out, np.float64), np.asarray(x, np.float64)
    kept = out != 0
    np.testing.assert_allclose(out[kept], x[kept] / (1 - rate), rtol=1e-6)
    sigma = (rate * (1 - rate) / x.size) ** 0.5
    assert abs(kept.mean() - (1 - rate)) < 5 * sigma
    return kept


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_dropout_holds_the_contract_of_jax_fused_dropout(rate):
    x = np.random.default_rng(0).uniform(0.5, 1.5, (4, 50, 512)).astype(
        np.float32)
    jseed = jnp.asarray([7, 11], jnp.int32)
    want = np.asarray(fused_dropout(jnp.asarray(x), jseed, rate, True))
    got = dropout.dropout(torch.from_numpy(x), rate, (7, 11)).numpy()
    if rate == 0.0:
        np.testing.assert_array_equal(got, x)
        np.testing.assert_array_equal(want, x)
        return
    for out in (got, want):
        _contract(out, x, rate)
    again = dropout.dropout(torch.from_numpy(x), rate, (7, 11)).numpy()
    np.testing.assert_array_equal(got, again)
    np.testing.assert_array_equal(
        want, np.asarray(fused_dropout(jnp.asarray(x), jseed, rate, True)))
    other = dropout.dropout(torch.from_numpy(x), rate, (8, 11)).numpy()
    assert not np.array_equal(got != 0, other != 0)
