"""Port parity for the streaming options of the conformer layers against
`cat_tpu.models.layers`, in float32 on the CPU: a `ConformerCell` with the
causal conv module (depthwise conv padded (k - 1, 0)), with an attention
context window (a band of keys), and with both, in eval and in training
mode (batch statistics, updated running statistics); the causal cell with
no right context sees no future frame; and the conv2d subsampling's
`time_chunk` (`ConformerNet(subsampling_chunk=…)`), equal to JAX's chunked
subsampling and to the port's unchunked one. Weights from the JAX
initialisation perturbed with numpy noise; tolerance rtol 1e-4, atol
1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.models import encoders as jax_encoders
from cat_tpu.models import layers as jax_layers
from cat_tpu_torch.models.encoders import ConformerNet
from cat_tpu_torch.models.layers import ConformerCell
from cat_tpu_torch.utils.from_jax import _cell, conformer_state_dict
from tests.test_torch_transducer import TOL, _np_tree, _perturbed

torch.set_num_threads(2)
D, H, K = 32, 4, 5
OPTIONS = {"causal": (True, (-1, -1)), "context": (False, (6, 2)),
           "both": (True, (4, 0)), "left only": (False, (3, -1))}


def _inputs(seed, N=3, T=23):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, T - 6, T - 11], np.int32)[:N]
    x = rng.standard_normal((N, T, D)).astype(np.float32)
    return x * (np.arange(T)[None, :, None] < lengths[:, None, None]), lengths


def _cells(causal, context, seed=0):
    jc = jax_layers.ConformerCell(D, H, kernel_size=K, causal_conv=causal,
                                  attention_context=context)
    x, lengths = _inputs(seed)
    v = jc.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(lengths))
    params = _perturbed(v["params"], seed + 1)
    stats = jax.tree_util.tree_map(
        lambda a: (np.abs(np.asarray(a)) + 0.5).astype(np.float32),
        v["batch_stats"])
    port = ConformerCell(D, H, kernel_size=K, causal_conv=causal,
                         attention_context=context)
    sd = {}
    _cell(sd, "", params, stats)
    port.load_state_dict(sd)
    return jc, params, stats, port


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_cell_options_match_jax(option, train):
    causal, context = OPTIONS[option]
    jc, params, stats, port = _cells(causal, context)
    x, lengths = _inputs(1)
    out = jc.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                   jnp.asarray(lengths), deterministic=not train,
                   mutable=["batch_stats"] if train else False)
    want, new_stats = out if train else (out, None)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if train:
        s = _np_tree(new_stats["batch_stats"])["ConvModule_0"]
        np.testing.assert_allclose(port.conv.running_mean.numpy(), s["mean"],
                                   **TOL)
        np.testing.assert_allclose(port.conv.running_var.numpy(), s["var"],
                                   **TOL)


def test_causal_cell_sees_no_future_frame():
    _, _, _, port = _cells(True, (5, 0))
    port.eval()
    x, lengths = _inputs(2)
    x2 = x.copy()
    x2[:, 12:] += np.random.default_rng(3).standard_normal(
        x2[:, 12:].shape).astype(np.float32)
    with torch.no_grad():
        a = port(torch.from_numpy(x), torch.from_numpy(lengths))
        b = port(torch.from_numpy(x2), torch.from_numpy(lengths))
    torch.testing.assert_close(a[:, :12], b[:, :12], rtol=0, atol=0)
    assert not torch.allclose(a[:, 12:], b[:, 12:])


@pytest.mark.parametrize("chunk,T", [(5, 60), (3, 41), (9, 30)])
def test_subsampling_chunk_matches_jax(chunk, T):
    kw = dict(num_cells=1, hdim=D, num_heads=H, kernel_size=K,
              dropout_rate=0.0)
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, 20)).astype(np.float32)
    lengths = np.array([T, T - 9], np.int32)
    jm = jax_encoders.ConformerNet(num_classes=6, subsampling_chunk=chunk,
                                   **kw)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths))
    params = _perturbed(v["params"], 4)
    stats = _np_tree(v["batch_stats"])
    want, want_len = jm.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), jnp.asarray(lengths))
    sd = conformer_state_dict(params, stats)
    got = {}
    for c in (chunk, 0):
        port = ConformerNet(num_classes=6, subsampling_chunk=c, idim=20, **kw)
        port.load_state_dict(sd)
        port.eval()
        with torch.no_grad():
            got[c] = port(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got[chunk][1].numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got[chunk][0].numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(got[chunk][0], got[0][0], rtol=1e-5, atol=1e-5)
