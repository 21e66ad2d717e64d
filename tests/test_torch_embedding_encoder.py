"""Port parity: JSA-SPG's token encoder `EmbeddingEncoder` and the layers
it adds (the unfused FF module, the LayerNorm conv module), in float32 on
the CPU against `cat_tpu`, weights carried across by `utils.from_jax`
(JAX's init perturbed by 0.05 so that biases and norms are not trivial).

- `EmbeddingEncoder` (vocabulary 7, 13 classes, 3 utterances of 12, 9
  and 5 tokens): at D = 16, 2 heads, 2 cells, conv kernel 3 (the
  template's width, where both packages take the unfused FF), and at D =
  128, 2 heads, 1 cell, kernel 15 (the fused FF: JAX's Pallas kernel in
  interpret mode, as tests/test_ffn_pallas.py runs it): logits within
  1e-5 + 1e-4·|x|, lengths equal; the gradient of a fixed random
  projection of the logits with respect to every parameter within 1e-4
  relative norm of JAX's (the key bias, whose exact gradient is 0, within
  1e-5 absolute on both sides: float32 noise), rate 0.
- The FF module at D = 16 and the LayerNorm conv module (D = 16, kernel
  3, residual folded in) alone: output and input gradient within 1e-5 +
  1e-4·|x|.
- Dispatch: a float32 CPU tensor takes the plain FF and attention
  versions, through every wrapper, and counts no launch of any kernel;
  the f32 wrappers on a CPU tensor are the plain versions; a float32
  tensor off the CPU and the card is refused.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.models import encoders as jax_encoders
from cat_tpu.models import layers as jax_layers
from cat_tpu_torch.models import get_encoder
from cat_tpu_torch.models.layers import ConvModule, FFModule, length_mask
from cat_tpu_torch.ops import attention, dropout, ffn
from cat_tpu_torch.utils.from_jax import (conv_module_state_dict,
                                          embedding_encoder_state_dict)
from tests.test_torch_transducer import _perturbed

torch.set_num_threads(2)
VOCAB, CLASSES = 7, 13
LENGTHS = np.array([12, 9, 5], np.int32)
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-4
NOISE = 1e-5  # the key bias's gradient: float32 noise around an exact 0
WIDTHS = {"d16": dict(num_cells=2, hdim=16, num_heads=2, kernel_size=3),
          "d128": dict(num_cells=1, hdim=128, num_heads=2, kernel_size=15)}


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(1, VOCAB, (len(LENGTHS), LENGTHS.max())).astype(np.int32)
    return t * (np.arange(LENGTHS.max())[None] < LENGTHS[:, None])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def pair(request):
    """(JAX module, perturbed params, port encoder) at one width; D = 128
    runs JAX's fused FF kernel in interpret mode."""
    kw = dict(WIDTHS[request.param], vocab_size=VOCAB, num_classes=CLASSES,
              dropout_rate=0.1)
    env = {"CAT_TPU_FUSED_FFN": "interpret", "CAT_TPU_PARTITIONED": "0"} \
        if request.param == "d128" else {}
    mp = pytest.MonkeyPatch()
    for k, v in env.items():
        mp.setenv(k, v)
    jm = jax_encoders.EmbeddingEncoder(**kw)
    toks = _tokens()
    params = _perturbed(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(toks), jnp.asarray(LENGTHS))
        ["params"], 1)
    model = get_encoder("EmbeddingEncoder")(**kw)
    model.load_state_dict(embedding_encoder_state_dict(params))
    yield request.param, jm, params, model
    mp.undo()


def test_forward_and_gradients_match_jax(pair):
    width, jm, params, model = pair
    toks = _tokens()
    proj = np.random.default_rng(3).standard_normal(
        (len(LENGTHS), LENGTHS.max(), CLASSES)).astype(np.float32)

    def objective(p):
        out, lens = jm.apply({"params": p}, jnp.asarray(toks),
                             jnp.asarray(LENGTHS))
        return jnp.sum(out * proj), (out, lens)

    (_, (out_j, lens_j)), g_j = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(params)
    model.zero_grad()
    out, lens = model(torch.from_numpy(toks), torch.from_numpy(LENGTHS))
    (out * torch.from_numpy(proj)).sum().backward()
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(lens_j))
    want = embedding_encoder_state_dict(g_j)
    grads = dict(model.named_parameters())
    assert set(want) == set(grads)
    for name, g in want.items():
        got = grads[name].grad.numpy()
        if name.endswith("mhsa.k.bias"):
            assert np.abs(got).max() < NOISE and np.abs(g).max() < NOISE
            continue
        assert _rel(got, g) < GRAD_RTOL, (width, name, _rel(got, g))
    assert model.cells[0].ff1.fused == (width == "d128")


def test_state_dict_is_the_converted_params(pair):
    _, _, params, model = pair
    sd = embedding_encoder_state_dict(params)
    assert set(sd) == set(model.state_dict())
    assert not any("bn_" in k or "running" in k for k in sd)


MODULES = {
    "ff16": (lambda: jax_layers.FFModule(16, 4, 0.0, residual_alpha=0.5),
             lambda: FFModule(16, 4, residual_alpha=0.5),
             lambda p: {"norm.weight": p["LayerNorm_0"]["scale"],
                        "norm.bias": p["LayerNorm_0"]["bias"],
                        "fc1.kernel": p["Dense_0"]["kernel"],
                        "fc1.bias": p["Dense_0"]["bias"],
                        "fc2.kernel": p["Dense_1"]["kernel"],
                        "fc2.bias": p["Dense_1"]["bias"]}),
    "conv_ln": (lambda: jax_layers.ConvModule(16, 3, 0.0, use_batchnorm=False,
                                              residual=True),
                lambda: ConvModule(16, 3, use_batchnorm=False),
                lambda p: conv_module_state_dict(p, {})),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name):
    make_j, make_t, convert = MODULES[name]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 12, 16)).astype(np.float32)
    mask = np.arange(12)[None] < LENGTHS[:, None]
    x *= mask[..., None]
    jm = make_j()
    call = (lambda p, xx: jm.apply({"params": p}, xx)) if name == "ff16" \
        else (lambda p, xx: jm.apply({"params": p}, xx, jnp.asarray(mask)))
    init = jm.init(jax.random.PRNGKey(2), jnp.asarray(x)) if name == "ff16" \
        else jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(mask))
    params = _perturbed(init["params"], 4)
    proj = rng.standard_normal(x.shape).astype(np.float32)
    out_j, vjp = jax.vjp(lambda xx: call(params, xx), jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(proj))
    mod = make_t()
    mod.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                         for k, v in convert(params).items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mod(xt) if name == "ff16" else mod(
        xt, length_mask(torch.from_numpy(LENGTHS), 12), torch.float32)
    (out * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **TOL)


def _wrappers():
    return (ffn.ff_forward, ffn.ff_backward, ffn.ff_forward_f32,
            ffn.ff_backward_f32, attention.relpos_attention_forward,
            attention.relpos_attention_backward,
            attention.relpos_attention_forward_f32,
            attention.relpos_attention_backward_f32, dropout.dropout_apply)


def test_float32_on_the_cpu_takes_the_plain_versions(monkeypatch):
    for w in _wrappers():
        monkeypatch.setattr(w, "launches", 0)
    model = get_encoder("EmbeddingEncoder")(
        vocab_size=VOCAB, num_cells=1, hdim=128, num_heads=2,
        num_classes=CLASSES, generator=torch.Generator().manual_seed(0))
    model.train()
    out, _ = model(torch.from_numpy(_tokens()), torch.from_numpy(LENGTHS))
    out.sum().backward()
    assert model.cells[0].ff1.fused
    assert all(w.launches == 0 for w in _wrappers())
    rng = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 128, generator=rng)
    ffp = (torch.ones(128), torch.zeros(128), torch.randn(128, 512) * 0.05,
           torch.zeros(512), torch.randn(512, 128) * 0.05, torch.zeros(128))
    assert torch.equal(ffn.ff_forward(x, *ffp), ffn.ff_reference(x, *ffp))
    q = torch.randn(1, 5, 2, 8, generator=rng)
    args = (q, q, q, torch.randn(9, 2, 8, generator=rng), torch.zeros(2, 8),
            torch.zeros(2, 8), torch.tensor([4]))
    got = attention.relpos_attention_forward(*args)
    want = attention.relpos_attention_reference_lse(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(w.launches == 0 for w in _wrappers())
    # the f32 wrappers themselves launch or raise: the device dispatch
    # lives in ff_forward / relpos_attention_forward alone
    with pytest.raises(ValueError, match="float32 CUDA"):
        ffn.ff_forward_f32(x, *ffp)
    with pytest.raises(ValueError, match="float32 CUDA"):
        attention.relpos_attention_forward_f32(*args)
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="float32 CUDA"):
        ffn.ff_forward_f32(meta(2, 3, 16), meta(16), meta(16), meta(16, 64),
                           meta(64), meta(64, 16), meta(16))
    with pytest.raises(ValueError, match="float32 CUDA"):
        attention.relpos_attention_forward_f32(
            meta(1, 4, 2, 8), meta(1, 4, 2, 8), meta(1, 4, 2, 8),
            meta(7, 2, 8), torch.zeros(2, 8), torch.zeros(2, 8),
            torch.tensor([4]))
    assert attention.F32_HEAD_DIMS == (8, 16, 32, 64, 128)
