"""The mask entry of the standalone dropout's library
(`cat_tpu_torch.ops.dropout.dropout_mask`) and the attention dropout of the
transformer decoders that draws its masks through it.

Checks: on the CPU `dropout_mask` is `dropout_scale`'s (1, rows, cols)
factors bit for bit, at row widths that are multiples of 4 and widths that
are not, and launches nothing (at rate 0 it does not reach the kernel
library either); `kernel_args` gives the kernels uint32 words;
`attend` (`models/decoders.py`) draws every training mask through
`dropout_mask`, one per attention call of `CausalTransformer` and two per
layer (self and cross) of `TransformerDecoder`, and none in eval mode, and
the decoders module no longer reaches `dropout_scale` itself.
"""
import ctypes
from unittest import mock

import numpy as np
import pytest
import torch

from cat_tpu_torch import _build
from cat_tpu_torch.models import decoders as pd
from cat_tpu_torch.ops import dropout


@pytest.mark.parametrize("rows, cols", [(46, 48), (46, 46), (5, 12),
                                        (7, 9), (1, 1), (33, 6)])
@pytest.mark.parametrize("stream", [0, 1])
def test_mask_is_dropout_scale_bit_for_bit(rows, cols, stream):
    seed = (0x0BADF00D, 0x5EED1234)
    before = dropout.dropout_mask.launches
    got = dropout.dropout_mask(seed, stream, rows, cols, 0.1, "cpu")
    want = dropout.dropout_scale(seed, stream, 1, rows, cols, 0.1, "cpu")
    assert got.shape == (1, rows, cols) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert set(got.unique().tolist()) <= {
        0.0, float(torch.tensor(1 / 0.9, dtype=torch.float32))}
    assert dropout.dropout_mask.launches == before


@pytest.mark.parametrize("device", [None, "cpu"])
def test_mask_launches_nothing_at_rate_0(device):
    before = dropout.dropout_mask.launches
    with mock.patch.object(_build, "load",
                           side_effect=AssertionError("kernel library")):
        got = dropout.dropout_mask(None, 0, 4, 6, 0.0, device)
        assert torch.equal(got, torch.ones(1, 4, 6))
        assert torch.equal(dropout.dropout_mask((3, 4), 0, 4, 6, 0.2, device),
                           dropout.dropout_scale((3, 4), 0, 1, 4, 6, 0.2))
    assert dropout.dropout_mask.launches == before


def test_kernel_args_are_the_uint32_words():
    """The seed words and the threshold as uint32 values, which ctypes
    hands a C `int` as the same bits; inv 1 / (1 - rate); rate 0 no
    dropout."""
    rng = np.random.default_rng(3)
    for _ in range(50):
        seed = tuple(int(w) for w in rng.integers(0, 1 << 32, 2))
        rate = float(rng.choice([0.1, 0.3, 0.5, 0.999, 1e-9]))
        words, inv = dropout.kernel_args(rate, seed)
        assert words == [*seed, dropout.threshold(rate)]
        assert inv == 1.0 / (1.0 - rate)
        assert [ctypes.c_int(w).value & 0xFFFFFFFF for w in words] == words
    assert dropout.kernel_args(0.0, None) == ([0, 0, 0], 1.0)
    with pytest.raises(ValueError, match="seed"):
        dropout.kernel_args(0.1, None)


def _spy(monkeypatch):
    masks = []
    real = pd.dropout_mask

    def spy(*args, **kw):
        masks.append(real(*args, **kw))
        return masks[-1]

    monkeypatch.setattr(pd, "dropout_mask", spy)
    return masks


def test_decoders_reach_no_plain_mask():
    assert not hasattr(pd, "dropout_scale")


def test_causal_transformer_draws_a_mask_per_attention_call(monkeypatch):
    masks = _spy(monkeypatch)
    U, V, L = 12, 11, 3
    model = pd.CausalTransformer(vocab_size=V, hdim=8, num_layers=L,
                                 num_heads=2, ff_dim=8, max_len=U,
                                 num_classes=V, dropout_rate=0.2,
                                 generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, V, (2, U)))
    with torch.no_grad():
        model.eval()
        model(toks)
        assert not masks
        model.train()
        model(toks, gen=torch.Generator().manual_seed(2))
    assert [tuple(m.shape) for m in masks] == [(1, U, U)] * L
    assert all(0 < float((m == 0).float().mean()) < 0.5 for m in masks)


def test_transformer_decoder_draws_self_and_cross_masks(monkeypatch):
    masks = _spy(monkeypatch)
    N, U, S, D, L = 2, 7, 9, 16, 2
    model = pd.TransformerDecoder(vocab_size=13, hdim=D, num_layers=L,
                                  num_heads=2, ff_dim=32, max_len=16,
                                  dropout_rate=0.3,
                                  generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, 13, (N, U)))
    memory = torch.from_numpy(rng.standard_normal((N, S, D)).astype(
        np.float32))
    lens = torch.tensor([U, U - 2])
    with torch.no_grad():
        model.eval()
        model(toks, lens, memory=memory)
        assert not masks
        model.train()
        model(toks, lens, gen=torch.Generator().manual_seed(3), memory=memory)
    assert [tuple(m.shape) for m in masks] == [(1, U, U), (1, U, S)] * L
