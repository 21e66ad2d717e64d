"""Port parity: the whole conformer encoder, JAX `ConformerNet` (eval,
flags off) against `cat_tpu_torch`'s with the weights carried across by
`from_jax`, in float32 on the CPU.

Covers both parameter layouts (`cell_{i}` and the stacked `cells` of
scan_layers) and remat's `CheckpointConv2dSubsampling_0` name. Biases,
norms and batch statistics are perturbed so every term is exercised.
Tolerance: logits rtol 1e-3, atol 1e-3; lengths and greedy hypotheses
identical.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax

from cat_tpu.ctc.decode import greedy_decode as jax_greedy
from cat_tpu.models.encoders import ConformerNet as JaxConformerNet
from cat_tpu_torch.ctc.decode import greedy_decode
from cat_tpu_torch.ctc.train import build_model
from cat_tpu_torch.utils.from_jax import conformer_state_dict

torch.set_num_threads(2)
KW = dict(num_cells=2, hdim=128, num_heads=2, kernel_size=15,
          num_classes=11, dropout_rate=0.0)


def jax_variables(model, x, lengths, seed):
    """Initialised, then perturbed, variables as numpy trees."""
    v = jax.jit(partial(model.init, deterministic=True))(
        jax.random.PRNGKey(seed), x, lengths)
    rng = np.random.default_rng(seed)
    noise = lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                       ).astype(np.float32)
    params = jax.tree_util.tree_map(noise, v["params"])
    stats = jax.tree_util.tree_map(lambda a: np.abs(noise(a)) + 0.5,
                                   v["batch_stats"])
    return params, stats


@pytest.mark.parametrize("layout", [{}, {"scan_layers": True},
                                    {"remat": True}])
def test_conformer_matches_jax(layout):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 40, 80)).astype(np.float32)
    lengths = np.array([40, 31, 17], np.int32)
    jm = JaxConformerNet(**KW, **layout)
    params, stats = jax_variables(jm, x, lengths, seed=len(layout))
    if layout.get("remat"):
        assert "CheckpointConv2dSubsampling_0" in params
    want, want_len = jax.jit(lambda v, x, l: jm.apply(
        v, x, l, deterministic=True))(
        {"params": params, "batch_stats": stats}, x, lengths)
    model = build_model({"encoder": {"type": "ConformerNet",
                                     "kwargs": dict(KW, **layout)}},
                        num_classes=KW["num_classes"], device="cpu")
    model.load_state_dict(conformer_state_dict(params, stats))
    with torch.inference_mode():
        got, got_len = model(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
    assert greedy_decode(torch.log_softmax(got, -1), got_len) == jax_greedy(
        jax.nn.log_softmax(want, -1), want_len)


def test_build_model_needs_cuda_unless_cpu_is_asked():
    cfg = {"encoder": {"type": "ConformerNet", "kwargs": KW}}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(cfg, num_classes=11)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model({"encoder": {"type": "VGGLSTM", "kwargs": {}}},
                    num_classes=11, device="cpu")
