"""Port parity: the (B)LSTM encoder, JAX `LSTM` (flax `nn.RNN` over
`nn.OptimizedLSTMCell`, no forget-gate offset) against `cat_tpu_torch`'s
with the weights carried across by `from_jax.lstm_encoder_state_dict`, in
float32 on the CPU, at hdim 8 and 32, 1 and 2 layers, bi- and
unidirectional, over utterances of three lengths in one padded batch.

Compared on valid frames only. A frame past an utterance's length holds
whatever the scan over the padding gives (the forward direction runs on
through the padded frames, the reverse one ends on them); no loss reads
it, since every loss and the next encoder layer's valid frames depend on
valid frames alone, so it is no part of the encoder's result.
Tolerance: outputs atol 1e-5, rtol 1e-5; gradients of a weighted sum of
the valid outputs against `jax.grad`, per parameter, atol 1e-4, rtol
1e-4; output lengths identical.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.models.encoders import LSTM as JaxLSTM
from cat_tpu_torch.ctc.train import build_model
from cat_tpu_torch.models.encoders import flip_sequences
from cat_tpu_torch.utils.from_jax import lstm_encoder_state_dict

torch.set_num_threads(2)
F, V = 6, 5
LENGTHS = np.array([23, 15, 6], np.int32)


def _case(hdim, layers, bidir, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 23, F)).astype(np.float32)
    x *= np.arange(23)[None, :, None] < LENGTHS[:, None, None]
    kw = dict(hdim=hdim, num_layers=layers, bidirectional=bidir,
              dropout_rate=0.0, num_classes=V)
    jm = JaxLSTM(**kw)
    v = jax.jit(partial(jm.init, deterministic=True))(
        jax.random.PRNGKey(seed), x, LENGTHS)
    # the biases start at zero: perturb every parameter so each term shows
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.2 * rng.standard_normal(a.shape))
        .astype(np.float32), v["params"])
    model = build_model({"encoder": {"type": "LSTM",
                                     "kwargs": dict(kw, idim=F)}},
                        num_classes=V, device="cpu")
    model.load_state_dict(lstm_encoder_state_dict(params, bidir))
    weights = rng.standard_normal((3, 23, V)).astype(np.float32)
    weights *= np.arange(23)[None, :, None] < LENGTHS[:, None, None]
    return jm, params, model, x, weights


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("hdim", [8, 32])
def test_lstm_encoder_matches_jax(hdim, layers, bidir):
    jm, params, model, x, weights = _case(hdim, layers, bidir)

    def objective(p):
        out, lens = jm.apply({"params": p}, x, LENGTHS, deterministic=True)
        return jnp.sum(out * weights), (out, lens)

    (_, (want, want_len)), grads = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(params)
    got, got_len = model(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    (got * torch.from_numpy(weights)).sum().backward()

    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    valid = np.arange(23)[None, :] < LENGTHS[:, None]
    np.testing.assert_allclose(got.detach().numpy()[valid],
                               np.asarray(want)[valid], rtol=1e-5, atol=1e-5)
    want_g = lstm_encoder_state_dict(
        jax.tree_util.tree_map(np.asarray, grads), bidir)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_flip_sequences_matches_flax():
    from flax.linen.recurrent import flip_sequences as flax_flip
    x = np.arange(3 * 7 * 2, dtype=np.float32).reshape(3, 7, 2)
    lens = np.array([7, 4, 1], np.int32)
    want = flax_flip(x, lens, num_batch_dims=1, time_major=False)
    got = flip_sequences(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        flip_sequences(got, torch.from_numpy(lens)).numpy(), x)


def test_dropout_between_layers_draws_from_the_generator():
    """Training mode at rate 0.5: the inter-layer dropout is a function of
    the step's generator, and drops something; eval mode is the identity
    on that path."""
    model = build_model({"encoder": {"type": "LSTM", "kwargs": dict(
        hdim=8, num_layers=2, dropout_rate=0.5, idim=F)}}, num_classes=V,
        device="cpu")
    x = torch.randn(2, 9, F, generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([9, 5])
    with torch.no_grad():
        ref, _ = model(x, lens)
        model.train()
        a, _ = model(x, lens, torch.Generator().manual_seed(3))
        b, _ = model(x, lens, torch.Generator().manual_seed(3))
        c, _ = model(x, lens, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, ref)
