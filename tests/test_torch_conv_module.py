"""Port parity: cat_tpu_torch.ops.conv_module's two fused stages against
the JAX package's Pallas kernels (interpret mode), in float32.

On a CPU tensor the port's wrappers take their plain PyTorch versions; the
CUDA kernels are held against those on the card by chip_smoke.py.
Tolerance: rtol 1e-4, atol 1e-4 (float32, sums in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cat_tpu.ops.conv_module_pallas import fused_bn_out as jax_bn_out
from cat_tpu.ops.conv_module_pallas import fused_glu_in as jax_glu_in
from cat_tpu_torch.ops import conv_module

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _case(N, T, D, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    lengths = np.array([T - 7 * i for i in range(N)])
    mask = np.arange(T)[None, :] < lengths[:, None]
    return f, mask


@pytest.mark.parametrize("N,T,D", [(2, 30, 128), (3, 17, 256)])
def test_glu_in_matches_jax(N, T, D):
    f, mask = _case(N, T, D, seed=D + T)
    x = f(N, T, D)
    params = (1 + f(D, scale=0.2), f(D, scale=0.1), f(D, 2 * D,
                                                      scale=D ** -0.5),
              f(2 * D, scale=0.05))
    want = np.asarray(jax_glu_in(jnp.asarray(x), jnp.asarray(mask),
                                 *map(jnp.asarray, params), interpret=True))
    got = conv_module.fused_glu_in(torch.from_numpy(x),
                                   torch.from_numpy(mask),
                                   *map(torch.from_numpy, params))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got.numpy()[~mask].any()


@pytest.mark.parametrize("N,T,D", [(2, 30, 128), (3, 17, 256)])
def test_bn_out_matches_jax(N, T, D):
    f, mask = _case(N, T, D, seed=D * T)
    conv, x = f(N, T, D), f(N, T, D)
    params = (f(D, scale=0.1), 1 + np.abs(f(D, scale=0.3)), 1 + f(D, scale=0.1),
              f(D, scale=0.1), f(D, D, scale=D ** -0.5), f(D, scale=0.05))
    want = np.asarray(jax_bn_out(jnp.asarray(conv), jnp.asarray(x),
                                 jnp.asarray(mask),
                                 *map(jnp.asarray, params), interpret=True))
    got = conv_module.fused_bn_out(torch.from_numpy(conv), torch.from_numpy(x),
                                   torch.from_numpy(mask),
                                   *map(torch.from_numpy, params))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got.numpy()[~mask], x[~mask])


def test_conv_stages_never_fall_back_off_the_cpu():
    """Off the CPU the wrappers launch their kernels or raise."""
    meta = lambda *s, dtype=torch.float32: torch.empty(*s, device="meta",
                                                       dtype=dtype)
    x, mask = meta(2, 5, 256), meta(2, 5, dtype=torch.bool)
    with pytest.raises(ValueError, match="bfloat16 CUDA"):
        conv_module.fused_glu_in(x, mask, meta(256), meta(256),
                                 meta(256, 512), meta(512))
    with pytest.raises(ValueError, match="bfloat16 CUDA"):
        conv_module.fused_bn_out(x, x, mask, *(meta(256) for _ in range(4)),
                                 meta(256, 256), meta(256))
