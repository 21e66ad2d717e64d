"""Port parity: the JAX `ConformerNet` options that the port now takes, in
float32 on the CPU against `cat_tpu`, weights carried across by
`utils.from_jax` (JAX's init perturbed by 0.05, running statistics drawn
away from 0 and 1).

- `use_batchnorm=False` (LayerNorm conv modules, no batch_stats),
  `subsampling="vgg2l"` (`VGG2LSubsampling`, its four convs and the
  projection after it) and `time_reduction_layer=0` (the mean of every 2
  frames after cell 0, the later cell's masks from the halved lengths):
  2 cells, D = 128, 2 heads, kernel 3, dropout 0, 3 utterances of 41,
  30 and 17 frames of 24 features. Eval logits and, in training mode,
  logits within 1e-5 + 1e-4·|x|, output lengths equal; the gradient of a
  fixed random projection of the training logits within 1e-4 relative
  norm of JAX's for every parameter (the key bias, and under batch
  normalisation the depthwise conv's bias, whose exact gradients are 0,
  within 1e-5 absolute on both sides).
- Their state-dict conversion: the converted keys are the port's, in
  the `cell_{i}` layout and in scan_layers' stacked `cells` (JAX keeps
  `cell_{i}` under scan_layers when a time reduction is set), and both
  layouts give the same state_dict.
- The time reduction alone: a mean in float32 in x's dtype, the odd last
  frame dropped, lengths // stride with a floor of 1.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.models import encoders as jax_encoders
from cat_tpu_torch.models import get_encoder
from cat_tpu_torch.models.layers import time_reduction
from cat_tpu_torch.utils.from_jax import conformer_state_dict
from tests.test_torch_transducer import _perturbed

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-4
NOISE = 1e-5
KW = dict(num_cells=2, hdim=128, num_heads=2, kernel_size=3, num_classes=11,
          dropout_rate=0.0)
IDIM = 24
LENGTHS = np.array([41, 30, 17], np.int32)
OPTIONS = {"no_batchnorm": dict(use_batchnorm=False),
           "vgg2l": dict(subsampling="vgg2l"),
           "time_reduction": dict(time_reduction_layer=0)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _feats(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, LENGTHS.max(), IDIM)).astype(np.float32)
    return x * (np.arange(LENGTHS.max())[None, :, None]
                < LENGTHS[:, None, None])


def _variables(jm, seed):
    v = jax.jit(partial(jm.init, deterministic=True))(
        jax.random.PRNGKey(seed), _feats(), LENGTHS)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.3 * np.abs(rng.standard_normal(a.shape))
                   ).astype(np.float32), dict(v.get("batch_stats", {})))
    return _perturbed(v["params"], seed + 1), stats


@pytest.fixture(scope="module", params=sorted(OPTIONS))
def pair(request):
    """(option, JAX module, perturbed variables, the port's model, JAX's
    results in one jitted call: eval logits and lengths, training logits
    and lengths, and the gradient of the projected training logits)."""
    opt = OPTIONS[request.param]
    jm = jax_encoders.ConformerNet(**KW, **opt)
    params, stats = _variables(jm, len(request.param))
    model = get_encoder("ConformerNet")(**KW, **opt, idim=IDIM)
    model.load_state_dict(conformer_state_dict(params, stats))
    x = _feats()
    out_shape = jax.eval_shape(partial(jm.apply, deterministic=True),
                               {"params": params, "batch_stats": stats}, x,
                               LENGTHS)[0].shape
    proj = np.random.default_rng(3).standard_normal(out_shape).astype(
        np.float32)

    def objective(p):
        (out, lens), _ = jm.apply(
            {"params": p, "batch_stats": stats}, x, LENGTHS,
            deterministic=False, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(5)})
        return jnp.sum(out * proj), (out, lens)

    def results(p):
        evals = jm.apply({"params": p, "batch_stats": stats}, x, LENGTHS,
                         deterministic=True)
        return evals, jax.value_and_grad(objective, has_aux=True)(p)

    return (request.param, jm, params, stats, model,
            (proj, jax.jit(results)(params)))


def test_eval_matches_jax(pair):
    name, jm, params, stats, model, (_, ((want, want_len), _)) = pair
    x = _feats()
    model.eval()
    with torch.inference_mode():
        got, got_len = model(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_training_and_gradients_match_jax(pair):
    name, jm, params, stats, model, (proj, res) = pair
    (_, (out_j, lens_j)), g_j = res[1]
    x = _feats()
    model.load_state_dict(conformer_state_dict(params, stats))
    model.train()
    model.zero_grad()
    out, lens = model(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    (out * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_array_equal(lens.numpy(), np.asarray(lens_j))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    want = conformer_state_dict(g_j, stats)
    grads = dict(model.named_parameters())
    assert set(grads) <= set(want)
    noise = ("mhsa.k.bias",) if name == "no_batchnorm" else (
        "mhsa.k.bias", "conv.depthwise.bias")
    for key, p in grads.items():
        got, g = p.grad.numpy(), want[key].numpy()
        if key.endswith(noise):
            assert np.abs(got).max() < NOISE and np.abs(g).max() < NOISE, key
            continue
        assert _rel(got, g) < GRAD_RTOL, (name, key, _rel(got, g))


def _restack(tree, n=2):
    """A `cell_{i}` tree in scan_layers' layout: one `cells` subtree whose
    leaves carry a leading num_cells axis."""
    out = {k: v for k, v in tree.items() if not k.startswith("cell_")}
    out["cells"] = jax.tree_util.tree_map(
        lambda *a: np.stack(a), *[tree[f"cell_{i}"] for i in range(n)])
    return out


def test_state_dict_in_both_layouts(pair):
    name, _, params, stats, model, _ = pair
    sd = conformer_state_dict(params, stats)
    assert set(sd) == set(model.state_dict())
    assert (stats == {}) == (name == "no_batchnorm")
    jm = jax_encoders.ConformerNet(**KW, **OPTIONS[name], scan_layers=True)
    shapes = jax.eval_shape(partial(jm.init, deterministic=True),
                            jax.random.PRNGKey(0), _feats(), LENGTHS)
    if name == "time_reduction":  # JAX scans no cells with a reduction
        assert "cells" not in shapes["params"]
        return
    stacked = _restack(params)
    shape = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shape(stacked) == shape(dict(shapes["params"]))
    sd_stacked = conformer_state_dict(stacked,
                                      _restack(stats) if stats else {})
    assert set(sd_stacked) == set(sd)
    for k in sd:
        assert torch.equal(sd_stacked[k], sd[k]), k
    if name == "vgg2l":
        assert sd["subsampling.convs.3.weight"].shape == (128, 128, 3, 3)
        assert sd["subsampling.proj.kernel"].shape == (IDIM // 4 * 128, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_time_reduction(dtype):
    x = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    h, lens = time_reduction(x.to(dtype), torch.tensor([5, 1]), 2)
    assert h.dtype == dtype and h.shape == (2, 2, 3)
    assert lens.tolist() == [2, 1]
    want = (x[:, 0:4:2] + x[:, 1:4:2]) / 2
    torch.testing.assert_close(h.float(), want.to(dtype).float())
