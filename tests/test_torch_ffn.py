"""Port parity: cat_tpu_torch.ops.ffn against the JAX package's fused FF
kernel (Pallas interpret mode) and its XLA reference, in float32.

On a CPU tensor the port's wrapper takes its plain PyTorch version; the
CUDA kernel is held against that version on the card by chip_smoke.py.
Tolerance: rtol 1e-4, atol 1e-4 (float32, sums in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cat_tpu.ops.ffn_pallas import ff_reference as jax_ff_reference
from cat_tpu.ops.ffn_pallas import fused_ff_residual as jax_fused_ff
from cat_tpu_torch.ops import ffn

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(N, T, D, F, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    x = f(N, T, D)
    params = (1 + f(D, scale=0.2), f(D, scale=0.1), f(D, F, scale=D ** -0.5),
              f(F, scale=0.05), f(F, D, scale=F ** -0.5), f(D, scale=0.05))
    return x, params


@pytest.mark.parametrize("N,T,D,F,alpha", [
    (2, 24, 128, 512, 0.5),
    (1, 37, 128, 256, 1.0),   # rows not a multiple of the tile
])
def test_ff_matches_jax(N, T, D, F, alpha):
    x, params = _inputs(N, T, D, F, seed=N * T)
    want = np.asarray(jax_fused_ff(jnp.asarray(x),
                                   *map(jnp.asarray, params), alpha=alpha,
                                   interpret=True))
    want_ref = np.asarray(jax_ff_reference(jnp.asarray(x),
                                           *map(jnp.asarray, params),
                                           alpha=alpha))
    got = ffn.fused_ff_residual(torch.from_numpy(x),
                                *map(torch.from_numpy, params), alpha=alpha)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)


def test_ff_cpu_path_does_not_launch():
    x, params = _inputs(1, 8, 128, 256, seed=1)
    before = ffn.fused_ff_residual.launches
    ffn.fused_ff_residual(torch.from_numpy(x), *map(torch.from_numpy, params))
    assert ffn.fused_ff_residual.launches == before


def test_ff_never_falls_back_off_the_cpu():
    """Off the CPU the wrapper launches its kernel or raises: a tensor the
    kernel cannot take (here on the meta device) is refused."""
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="bfloat16 CUDA"):
        ffn.fused_ff_residual(meta(2, 3, 128), meta(128), meta(128),
                              meta(128, 512), meta(512), meta(512, 128),
                              meta(128))
