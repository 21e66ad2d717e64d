"""Port parity of the LM decoders (`cat_tpu_torch/models/decoders.py`)
against `cat_tpu.models.decoders`: the same JAX parameters, carried over
by `utils/from_jax.py`, on the same seeded token batches, in float32.

- `LSTMPredictor` with an untied and a tied LM head, over full sequences
  and step by step; the `Embedding` LM; `SyllableEnhancedLSTM`;
  `CausalTransformer` (padded lengths; the tied and the dense head; a
  query whose keys are all masked attends uniformly, as flax's): outputs
  within 1e-4, and the masked CE loss's gradients within 1e-4 relative
  norm per parameter at dropout 0.
- The attention probabilities' dropout at rate > 0: one mask a call,
  shared by the batch and the heads, keeping about 1 - rate.
- The converters round-trip every parameter (no key missing or extra).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu.models import decoders as jd
from cat_tpu_torch import models
from cat_tpu_torch.models import decoders as pd
from cat_tpu_torch.utils.from_jax import model_state_dict

V = 13
RTOL_GRAD = 1e-4


def _tokens(seed, N=4, U=9, V=V):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, V, (N, U)).astype(np.int32)
    lens = np.asarray([U, U - 3, 2, 1][:N], np.int32)
    return toks, lens


def _pair(jmod, pmod, toks, lens):
    """JAX params of `jmod` and the port's `pmod` holding them."""
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmod.init)(
        jax.random.PRNGKey(3), jnp.asarray(toks), jnp.asarray(lens))
        ["params"])
    sd = model_state_dict(pmod, params, {})
    missing, extra = pmod.load_state_dict(sd, strict=False)
    assert not missing and not extra, (missing, extra)
    assert set(sd) == set(pmod.state_dict())
    return params


def _masked_ce_jax(jmod, params, toks, targets, lens):
    logits, _ = jmod.apply({"params": params}, toks, lens)
    lp = jax.nn.log_softmax(logits, -1)
    nll = -jnp.take_along_axis(lp, targets[..., None], -1)[..., 0]
    mask = jnp.arange(toks.shape[1])[None, :] < lens[:, None]
    return jnp.sum(jnp.where(mask, nll, 0.0)) / jnp.sum(mask)


def _check_forward_and_grads(jmod, pmod, toks, lens, seed=1):
    params = _pair(jmod, pmod, toks, lens)
    jt, jl = jnp.asarray(toks), jnp.asarray(lens)
    want, _ = jax.jit(jmod.apply)({"params": params}, jt, jl)
    got, _ = pmod(torch.from_numpy(toks).long(), torch.from_numpy(lens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    targets = np.random.default_rng(seed).integers(
        0, got.shape[-1], toks.shape).astype(np.int32)
    jgrads = jax.grad(lambda p: _masked_ce_jax(jmod, p, jt, jnp.asarray(
        targets), jl))(params)
    lp = torch.log_softmax(got, -1)
    nll = -lp.gather(-1, torch.from_numpy(targets).long()[..., None])[..., 0]
    mask = torch.arange(toks.shape[1])[None, :] < torch.from_numpy(
        lens)[:, None]
    (torch.where(mask, nll, 0.0).sum() / mask.sum()).backward()
    want_g = model_state_dict(pmod, jax.tree_util.tree_map(np.asarray,
                                                           jgrads), {})
    for name, p in pmod.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        w = want_g[name]
        err = float((g - w).norm() / max(float(w.norm()), 1e-12))
        assert err <= RTOL_GRAD or float((g - w).abs().max()) < 1e-7, \
            (name, err)
    return params


@pytest.mark.parametrize("tied,layers,edim", [(False, 1, 0), (False, 2, 6),
                                              (True, 2, 0)])
def test_lstm_lm_matches_jax(tied, layers, edim):
    kw = dict(vocab_size=V, hdim=8, num_layers=layers, edim=edim,
              num_classes=V, with_head=True, tied=tied)
    toks, lens = _tokens(0)
    jmod = jd.LSTMPredictor(**kw)
    pmod = pd.LSTMPredictor(**kw)
    params = _check_forward_and_grads(jmod, pmod, toks, lens)
    assert ("classifier" in params) == (not tied)
    assert (pmod.classifier is None) == tied
    # step by step from the initial state: the full pass's rows
    jstate = jmod.apply({"params": params}, 4, method=jmod.init_state)
    state = pmod.init_state(4)
    for u in range(toks.shape[1]):
        jout, jstate = jmod.apply({"params": params},
                                  jnp.asarray(toks[:, u]), jstate,
                                  method=jmod.step)
        with torch.no_grad():
            out, state = pmod.step(torch.from_numpy(toks[:, u]), state)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                                   atol=1e-4)


def test_tied_lstm_head_needs_edim_equal_hdim():
    with pytest.raises(ValueError, match="edim == hdim"):
        pd.LSTMPredictor(vocab_size=V, hdim=8, edim=6, num_classes=V,
                         with_head=True, tied=True)


def test_embedding_lm_matches_jax():
    kw = dict(vocab_size=V, hdim=6, num_classes=V, with_head=True)
    toks, lens = _tokens(2)
    jmod, pmod = jd.Embedding(**kw), pd.Embedding(**kw)
    params = _check_forward_and_grads(jmod, pmod, toks, lens)
    jout, _ = jmod.apply({"params": params}, jnp.asarray(toks[:, 3]), (),
                         method=jmod.step)
    with torch.no_grad():
        out, st = pmod.step(torch.from_numpy(toks[:, 3]), ())
    assert st == ()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)


def test_syllable_enhanced_lstm_matches_jax():
    conv = [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6]
    toks, lens = _tokens(4)
    jmod = jd.SyllableEnhancedLSTM(V, conv, hdim=8, num_classes=V,
                                   with_head=True)
    pmod = models.get_decoder("SyllableEnhancedLSTM")(
        V, conv, hdim=8, num_classes=V, with_head=True)
    params = _check_forward_and_grads(jmod, pmod, toks, lens)
    assert params["syl_embed"]["embedding"].shape == (7, 8)
    # the converter is a non-persistent buffer, not a parameter
    assert "syllable_of" not in pmod.state_dict()


@pytest.mark.parametrize("tied,classes", [(True, V), (False, V),
                                          (True, 7)])
def test_causal_transformer_matches_jax(tied, classes):
    kw = dict(vocab_size=V, hdim=16, num_layers=2, num_heads=4, ff_dim=24,
              max_len=12, num_classes=classes, dropout_rate=0.0, tied=tied)
    toks, lens = _tokens(5)
    jmod, pmod = jd.CausalTransformer(**kw), pd.CausalTransformer(**kw)
    params = _check_forward_and_grads(jmod, pmod, toks, lens)
    assert ("head" in params) == (not (tied and classes == V))
    assert all(m.eps == 1e-6 for m in pmod.modules()
               if isinstance(m, torch.nn.LayerNorm))


def test_causal_transformer_without_lengths_and_fully_masked_rows():
    """No lengths: the causal mask alone. Length 0: every key masked, the
    scores at the float32 minimum, uniform attention (flax), no NaN."""
    kw = dict(vocab_size=V, hdim=8, num_layers=1, num_heads=2, ff_dim=8,
              max_len=8, num_classes=V, dropout_rate=0.0)
    toks, _ = _tokens(6, N=2, U=5)
    jmod, pmod = jd.CausalTransformer(**kw), pd.CausalTransformer(**kw)
    params = _pair(jmod, pmod, toks, np.asarray([5, 5], np.int32))
    for lens in (None, np.asarray([0, 3], np.int32)):
        want, _ = jmod.apply({"params": params}, jnp.asarray(toks),
                             None if lens is None else jnp.asarray(lens))
        with torch.no_grad():
            got, _ = pmod(torch.from_numpy(toks), None if lens is None
                          else torch.from_numpy(lens))
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)


def test_attention_dropout_keeps_one_minus_rate(monkeypatch):
    masks = []
    scale = pd.dropout_mask

    def spy(*args, **kw):
        masks.append(scale(*args, **kw))
        return masks[-1]

    monkeypatch.setattr(pd, "dropout_mask", spy)
    U, rate = 64, 0.3
    model = pd.CausalTransformer(vocab_size=V, hdim=8, num_layers=2,
                                 num_heads=2, ff_dim=8, max_len=U,
                                 num_classes=V, dropout_rate=rate,
                                 generator=torch.Generator().manual_seed(0))
    model.eval()
    toks = torch.from_numpy(_tokens(7, N=3, U=U)[0])
    with torch.no_grad():
        ref, _ = model(toks)
        assert not masks  # eval mode: no dropout
        model.train()
        a, _ = model(toks, gen=torch.Generator().manual_seed(1))
        b, _ = model(toks, gen=torch.Generator().manual_seed(1))
    assert len(masks) == 4 and masks[0].shape == (1, U, U)
    keep = torch.cat([(m > 0).float().flatten() for m in masks]).mean()
    assert abs(float(keep) - (1 - rate)) < 0.02
    assert torch.unique(masks[0]).tolist() == [
        0.0, float(torch.tensor(1 / (1 - rate), dtype=torch.float32))]
    assert torch.equal(a, b) and not torch.allclose(a, ref)


def test_transformer_decoder_names_its_section():
    # raised NotImplementedError naming §A.8 until the P2G slice ported
    # it; its parity with JAX's is tests/test_torch_p2g.py's
    assert models.get_decoder("TransformerDecoder") is pd.TransformerDecoder
