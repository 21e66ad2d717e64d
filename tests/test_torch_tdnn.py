"""Port parity: the TDNN encoder (wsj crf-tdnn), in float32 on the CPU.

- `TDNNLayer` against the JAX layer at strides 1 and 2, dilations 1 and 3
  and half contexts 1 and 2: outputs atol 1e-5, rtol 1e-5, lengths exact.
- `TDNN_NAS` at hdim 32 and V = 8 (the size of `tests/test_models.py`) on
  three utterances of unequal length at dropout 0, weights carried across
  by `from_jax.tdnn_state_dict`: logits on every frame, padded ones too
  (neither package masks the padding, and both carry it alike into the
  last valid frames), rtol 1e-4, atol 1e-4; lengths exact.
- One CTC-CRF loss and its gradient against `jax.grad` of `cat_tpu`'s
  `make_loss_fn` (dense 3-gram denominator, lambda 0.01, the crf-tdnn
  recipe's): loss rtol 1e-4, every parameter's gradient rtol 1e-4, atol
  1e-4.
- Dropout in training mode draws the port's Philox mask (row 1's kernel
  on the card): the same mask forward and backward, seeded by the step's
  generator.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ctc import train as jax_train
from cat_tpu.fst.ngram import train_ngram as jax_train_ngram
from cat_tpu.models.layers import TDNNLayer as JaxTDNNLayer
from cat_tpu.ops.crf_dense import DenseDen as JaxDenseDen
from cat_tpu_torch.ctc import train
from cat_tpu_torch.fst.ngram import train_ngram
from cat_tpu_torch.models.layers import TDNNLayer
from cat_tpu_torch.ops.crf_dense import DenseDen
from cat_tpu_torch.utils.from_jax import tdnn_state_dict

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
F, V, LAMB = 20, 8, 0.01
LENGTHS = np.array([60, 47, 33], np.int32)
ENC = {"type": "TDNN_NAS", "kwargs": {"hdim": 32, "dropout_rate": 0.0}}


def _feats(seed=0, T=60, dim=F):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, T, dim)).astype(np.float32)
    return x * (np.arange(T)[None, :, None] < LENGTHS[:, None, None])


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


@pytest.mark.parametrize("half_context,dilation,stride",
                         [(1, 1, 1), (1, 1, 2), (1, 3, 1), (2, 3, 2)])
def test_tdnn_layer_matches_jax(half_context, dilation, stride):
    x = _feats(1)
    jm = JaxTDNNLayer(16, half_context, dilation, stride)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), x, LENGTHS)
    params = _perturbed(v["params"], 2)
    want, want_len = jm.apply({"params": params}, x, LENGTHS)
    layer = TDNNLayer(F, 16, half_context, dilation, stride)
    k = params["Conv_0"]["kernel"]                      # (k, in, out)
    layer.load_state_dict({
        "conv.weight": torch.from_numpy(np.transpose(k, (2, 1, 0)).copy()),
        "conv.bias": torch.from_numpy(params["Conv_0"]["bias"])})
    got, got_len = layer(torch.from_numpy(x).transpose(1, 2),
                         torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.transpose(1, 2).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def _seqs():
    rng = np.random.default_rng(1)
    return [list(map(int, rng.integers(1, V, size=int(rng.integers(3, 10)))))
            for _ in range(50)]


def _batch():
    rng = np.random.default_rng(3)
    llens = np.array([9, 7, 4], np.int32)
    labels = rng.integers(1, V, (3, 9)).astype(np.int32)
    labels *= np.arange(9)[None, :] < llens[:, None]
    return {"feats": _feats(), "feat_lengths": LENGTHS, "labels": labels,
            "label_lengths": llens,
            "weight": np.array([1.0, 0.5, 2.0], np.float32)}


@pytest.fixture(scope="module")
def jax_side():
    """JAX TDNN_NAS variables (perturbed), its logits, and the CTC-CRF loss
    and gradients of one batch, as numpy."""
    model = jax_train.build_model({"encoder": ENC}, V)
    batch = _batch()
    v = jax.jit(partial(model.init, deterministic=True))(
        jax.random.PRNGKey(0), batch["feats"], LENGTHS)
    params = _perturbed(v["params"], 4)
    logits, olens = jax.jit(partial(model.apply, deterministic=True))(
        {"params": params}, batch["feats"], LENGTHS)
    den = JaxDenseDen.from_ngram(jax_train_ngram(_seqs(), order=3), V)
    loss_fn = jax_train.make_loss_fn(model, "crf", den, LAMB, None)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        partial(loss_fn, train=True), has_aux=True))(
        params, {}, {k: jnp.asarray(a) for k, a in batch.items()},
        jax.random.PRNGKey(1))
    to_np = partial(jax.tree_util.tree_map, np.asarray)
    return {"params": to_np(params), "logits": np.asarray(logits),
            "olens": np.asarray(olens), "loss": float(loss),
            "grads": to_np(grads)}


def _port(jax_side):
    model = train.build_model({"encoder": {**ENC, "kwargs": dict(
        ENC["kwargs"], idim=F)}}, V, device="cpu")
    model.load_state_dict(tdnn_state_dict(jax_side["params"]))
    return model


def test_tdnn_nas_matches_jax(jax_side):
    model = _port(jax_side)
    with torch.no_grad():
        got, got_len = model(torch.from_numpy(_feats()),
                             torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(got_len.numpy(), jax_side["olens"])
    np.testing.assert_array_equal(got_len.numpy(), (LENGTHS + 1) // 2)
    assert got.shape == jax_side["logits"].shape == (3, 30, V)
    np.testing.assert_allclose(got.numpy(), jax_side["logits"], **TOL)
    # the padding reaches the last valid frames, alike in both packages
    x = _feats()
    x[1, LENGTHS[1]:] = 1.0
    with torch.no_grad():
        leaked, _ = model(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    last = (LENGTHS[1] + 1) // 2 - 1
    assert not torch.allclose(leaked[1, last], got[1, last])


def test_ctc_crf_gradient_matches_jax(jax_side):
    model = _port(jax_side)
    den = DenseDen.from_ngram(train_ngram(_seqs(), order=3), V)
    batch = {k: torch.from_numpy(a) for k, a in _batch().items()}
    model.train()
    loss, _ = train.make_loss_fn(model, "crf", den, LAMB)(batch, None, True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_side["loss"], rtol=1e-4)
    want = tdnn_state_dict(jax_side["grads"])
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name].numpy(),
                                   err_msg=name, **TOL)


def test_dropout_draws_one_mask_each_way():
    model = train.build_model({"encoder": {"type": "TDNN_NAS", "kwargs": {
        "hdim": 32, "dropout_rate": 0.5, "idim": F}}}, V, device="cpu")
    model.train()
    x = torch.from_numpy(_feats())
    lens = torch.from_numpy(LENGTHS)
    a, _ = model(x, lens, torch.Generator().manual_seed(0))
    b, _ = model(x, lens, torch.Generator().manual_seed(0))
    c, _ = model(x, lens, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the backward re-draws the forward's mask: the gradient at the last
    # layer's output is zero where its dropout dropped, about half of it
    h = torch.from_numpy(_feats()).requires_grad_()
    seen = {}
    last = model.layers[-1]
    hook = last.register_forward_hook(
        lambda m, i, out: seen.update(out=out[0]) or out[0].retain_grad())
    try:
        y, _ = model(h, lens, torch.Generator().manual_seed(0))
    finally:
        hook.remove()
    y.sum().backward()
    g = seen["out"].grad
    kept = (g != 0).float().mean().item()
    assert 0.4 < kept < 0.6
    with pytest.raises(ValueError, match="Generator"):
        model(x, lens)
