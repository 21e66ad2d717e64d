"""Port parity for the conv module's glu_in stage at the edges that its
CUDA kernels (`cat_tpu_torch/csrc/glu_in.cu`) are held to on the card, in
float32 on the CPU.

`glu_in_reference` and `glu_in_backward_reference`, the plain versions
that the kernels are compared with in `tests/test_torch_cuda.py` and
`chip_smoke.py`, against the JAX package's `fused_glu_in` (its Pallas
kernels in interpret mode, and `jax.grad` through them) at the widths 384
and 512, one row, a mask with every frame off, and rows of zero variance
(constant and zero rows, which a layer norm's backward multiplies by
1/sqrt(eps) = 1000). A mask with every frame off gives zero gradients
exactly, as the kernels' sums without atomics must too.
The constant rows hold 0.75, whose mean every order of summation gives
exactly: where the mean rounds, x - mean is a rounding residue that the
backward multiplies by 1000, a different one in each package (0.6 % of
such a row's dx at D = 512), which the card's tests hold to a relative
norm instead.
Tolerance: rtol 1e-4, atol 1e-4 (float32, sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ops.conv_module_pallas import fused_glu_in as jax_glu_in
from cat_tpu_torch.ops import conv_module

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _case(N, T, D, mask, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    x, g = f(N, T, D), f(N, T, D)
    if T >= 8:  # a constant row and a zero row in every utterance
        x[:, T // 2] = 0.75
        x[:, T // 2 + 1] = 0
    lengths = {"ragged": np.array([T] + [max(T // 2, 1)] * (N - 1)),
               "zero": np.zeros(N, np.int64)}[mask]
    m = np.arange(T)[None, :] < lengths[:, None]
    params = (1 + f(D, scale=0.2), f(D, scale=0.1),
              f(D, 2 * D, scale=D ** -0.5), f(2 * D, scale=0.05))
    return x, g, m, params


CASES = [(1, 1, 384, "ragged"), (2, 12, 512, "ragged"), (2, 9, 384, "zero"),
         (1, 10, 512, "zero")]


@pytest.mark.parametrize("N,T,D,mask", CASES)
def test_glu_in_forward_matches_jax_at_the_kernels_edges(N, T, D, mask):
    x, _, m, params = _case(N, T, D, mask, seed=N + T + D)
    want = np.asarray(jax_glu_in(jnp.asarray(x), jnp.asarray(m),
                                 *map(jnp.asarray, params), interpret=True))
    got = conv_module.glu_in_forward(torch.from_numpy(x),
                                     torch.from_numpy(m),
                                     *map(torch.from_numpy, params))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got.numpy()[~m].any()


@pytest.mark.parametrize("N,T,D,mask", CASES)
def test_glu_in_backward_matches_jax_at_the_kernels_edges(N, T, D, mask):
    x, g, m, params = _case(N, T, D, mask, seed=7 * (N + T + D))
    want = jax.grad(
        lambda x, *p: jnp.sum(jax_glu_in(x, jnp.asarray(m), *p,
                                         interpret=True) * g),
        argnums=tuple(range(5)))(jnp.asarray(x), *map(jnp.asarray, params))
    got = conv_module.glu_in_backward(torch.from_numpy(x), torch.from_numpy(m),
                                      *map(torch.from_numpy, params),
                                      torch.from_numpy(g))
    for name, a, b in zip("x gamma beta w b".split(), got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=name, **TOL)
        if mask == "zero":
            assert not np.asarray(a).any(), name
