"""Port parity: cat_tpu_torch.ops.attention against the JAX package's
rel-pos attention, in float32.

Up to 512 frames the JAX side is the packed flash kernel in Pallas
interpret mode (the TPU default); above it, `relpos_attention_reference`
(the tiled kernel's interpret mode at that length is left to cat_tpu's
own tests). The port's wrapper on a CPU tensor takes its plain version;
the CUDA kernel is held against that on the card by chip_smoke.py.
Tolerance: rtol 1e-4, atol 1e-4 on valid query rows.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cat_tpu.models.layers import rel_positional_encoding as jax_pe
from cat_tpu.ops.attention_pallas import (flash_relpos_attention_packed,
                                          relpos_attention_reference)
from cat_tpu_torch.models.layers import rel_positional_encoding
from cat_tpu_torch.ops import attention

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(N, T, H, Dh, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    q, k, v = f(N, T, H, Dh), f(N, T, H, Dh), f(N, T, H, Dh)
    u, vb = f(H, Dh, scale=0.1), f(H, Dh, scale=0.1)
    lengths = np.maximum(T - 9 * np.arange(N), 1)
    lengths[-1] = max(T // 3, 1)
    return q, k, v, u, vb, lengths


def _port(q, k, v, p, u, vb, lengths):
    t = torch.from_numpy
    return attention.relpos_attention(t(q), t(k), t(v), t(p), t(u), t(vb),
                                      t(lengths)).numpy()


def test_pe_table_matches_jax():
    got = rel_positional_encoding(23, 64).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_pe(23, 64)), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("N,T,H,Dh", [(2, 40, 2, 64), (3, 21, 4, 16)])
def test_attention_matches_jax_packed(N, T, H, Dh):
    q, k, v, u, vb, lengths = _inputs(N, T, H, Dh, seed=T)
    D = H * Dh
    w = (np.random.default_rng(1).standard_normal((D, H, Dh))
         * D ** -0.5).astype(np.float32)
    kmask = np.arange(T)[None, :] < lengths[:, None]
    F = H * Dh
    want = np.asarray(flash_relpos_attention_packed(
        jnp.asarray(q.reshape(N, T, F)), jnp.asarray(k.reshape(N, T, F)),
        jnp.asarray(v.reshape(N, T, F)), jnp.asarray(w), jnp.asarray(u),
        jnp.asarray(vb), jnp.asarray(kmask), interpret=True))
    # the port takes the projected table p = pe . W_pos, as the layer does
    p = (rel_positional_encoding(T, D) @ torch.from_numpy(w.reshape(D, D)))
    got = _port(q, k, v, p.numpy().reshape(2 * T - 1, H, Dh), u, vb, lengths)
    np.testing.assert_allclose(got.reshape(N, T, F)[kmask], want[kmask],
                               **TOL)


def test_attention_long_matches_jax_reference():
    N, T, H, Dh = 1, 600, 2, 16
    q, k, v, u, vb, lengths = _inputs(N, T, H, Dh, seed=5)
    lengths[0] = 587
    p = (np.random.default_rng(2).standard_normal((2 * T - 1, H, Dh))
         * 0.5).astype(np.float32)
    kmask = np.arange(T)[None, :] < lengths[:, None]
    want = np.asarray(relpos_attention_reference(
        *map(jnp.asarray, (q, k, v, p, u, vb, kmask))))
    got = _port(q, k, v, p, u, vb, lengths)
    np.testing.assert_allclose(got[kmask], want[kmask], **TOL)


def test_attention_never_falls_back_off_the_cpu():
    """Off the CPU the wrapper launches its kernel or raises."""
    q = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="bfloat16 CUDA"):
        attention.relpos_attention(q, q, q, torch.empty(7, 2, 64,
                                                        device="meta"),
                                   torch.zeros(2, 64), torch.zeros(2, 64),
                                   torch.tensor([4]))
