"""RNN-T predictors in PyTorch (counterparts of `LSTMPredictor`,
`Embedding` and `ZeroDecoder` in `cat_tpu/models/decoders.py`).

API as the JAX modules: `forward(tokens, lengths, gen=None)` -> (hidden,
lengths) for full sequences; `init_state(batch, device)` and
`step(tokens, state)` -> (hidden, state) for incremental decoding. The
LSTM cell is written out with plain matrix products, including the JAX
cell's forget-gate bias of +1.0 inside the sigmoid (which
`torch.nn.LSTM` lacks), and the full-sequence pass runs the same cell
function as `step`, so the two give identical outputs. Everything runs in
float32, as the JAX modules do. The LM heads (`with_head`, `tied`), the
syllable-enhanced embedding and the transformer decoders belong to the
LM slice (ROADMAP.md).
"""
from __future__ import annotations

import torch
from torch import nn

from cat_tpu_torch.models.layers import Dropout


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported to cat_tpu_torch yet; "
                               "see ROADMAP.md")


def lstm_step(wx, wh, b, carry, x):
    """One LSTM cell on explicit parameters (`_lstm_step` of the JAX
    package): gates i, f, g, o of x·wx + h·wh + b, with sigmoid(f + 1)."""
    c, h = carry
    gates = x @ wx + h @ wh + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (c, h), h


class LSTMPredictor(nn.Module):
    """Embedding -> LSTM stack, dropout between layers."""

    def __init__(self, vocab_size, hdim=640, num_layers=1, edim=0,
                 num_classes=0, dropout_rate=0.0, with_head=False,
                 tied=False, syllable_converter=None, generator=None):
        super().__init__()
        if with_head or tied:
            raise _not_ported("LSTMPredictor's LM head")
        if syllable_converter is not None:
            raise _not_ported("the syllable-enhanced LSTM predictor")
        edim = edim or hdim
        self.hdim = hdim
        self.num_layers = num_layers
        self.embed = nn.Embedding(vocab_size, edim)
        for i in range(num_layers):
            din = edim if i == 0 else hdim
            self.register_parameter(f"lstm_{i}_wx", nn.Parameter(
                torch.empty(din, 4 * hdim)))
            self.register_parameter(f"lstm_{i}_wh", nn.Parameter(
                torch.empty(hdim, 4 * hdim)))
            self.register_parameter(f"lstm_{i}_b", nn.Parameter(
                torch.zeros(4 * hdim)))
        self.dropout = Dropout(dropout_rate)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Random weights drawn on the CPU from `generator`: the embedding
        normal with variance 1/edim, wx normal with variance 1/fan_in, wh
        orthogonal, biases zero (the JAX package's initialisers, without
        truncation or Glorot scaling)."""
        w = self.embed.weight
        w.copy_(torch.randn(w.shape, generator=generator) / w.shape[1] ** 0.5)
        for i in range(self.num_layers):
            wx = getattr(self, f"lstm_{i}_wx")
            wx.copy_(torch.randn(wx.shape, generator=generator)
                     / wx.shape[0] ** 0.5)
            wh = getattr(self, f"lstm_{i}_wh")
            q, _ = torch.linalg.qr(torch.randn(wh.shape[1], wh.shape[0],
                                               generator=generator))
            wh.copy_(q.T)
            getattr(self, f"lstm_{i}_b").zero_()

    def _layer(self, i):
        return (getattr(self, f"lstm_{i}_wx"), getattr(self, f"lstm_{i}_wh"),
                getattr(self, f"lstm_{i}_b"))

    def forward(self, tokens, lengths=None, gen=None):
        """tokens (N, U) -> (hidden (N, U, hdim) f32, lengths)."""
        x = self.embed(tokens.long())
        N, U = tokens.shape
        for i in range(self.num_layers):
            zeros = x.new_zeros(N, self.hdim)
            carry, hs = (zeros, zeros), []
            for u in range(U):
                carry, h = lstm_step(*self._layer(i), carry, x[:, u])
                hs.append(h)
            x = torch.stack(hs, 1) if hs else x.new_zeros(N, 0, self.hdim)
            if i < self.num_layers - 1:
                x = self.dropout(x, gen)
        return x, lengths

    def init_state(self, batch_size, device=None):
        return tuple((torch.zeros(batch_size, self.hdim, device=device),
                      torch.zeros(batch_size, self.hdim, device=device))
                     for _ in range(self.num_layers))

    def step(self, tokens, state):
        """One decode step: tokens (N,) -> (out (N, hdim), new state)."""
        x = self.embed(tokens.long())
        new_state = []
        for i, st in enumerate(state):
            st, x = lstm_step(*self._layer(i), st, x)
            new_state.append(st)
        return x, tuple(new_state)


class Embedding(nn.Module):
    """Context-1 embedding predictor."""

    def __init__(self, vocab_size, hdim=256, num_classes=0, with_head=False,
                 generator=None):
        super().__init__()
        if with_head:
            raise _not_ported("the Embedding predictor's LM head")
        self.hdim = hdim
        self.embed = nn.Embedding(vocab_size, hdim)
        with torch.no_grad():
            w = self.embed.weight
            w.copy_(torch.randn(w.shape, generator=generator) / hdim ** 0.5)

    def forward(self, tokens, lengths=None, gen=None):
        return self.embed(tokens.long()), lengths

    def init_state(self, batch_size, device=None):
        return ()

    def step(self, tokens, state):
        return self.embed(tokens.long()), state


class ZeroDecoder(nn.Module):
    """Stateless zero predictor (a decoder-free transducer)."""

    def __init__(self, hdim=1, vocab_size=0, generator=None):
        super().__init__()
        self.hdim = hdim

    def forward(self, tokens, lengths=None, gen=None):
        N, U = tokens.shape
        return torch.zeros(N, U, self.hdim, device=tokens.device), lengths

    def init_state(self, batch_size, device=None):
        return ()

    def step(self, tokens, state):
        return torch.zeros(tokens.shape[0], self.hdim,
                           device=tokens.device), state
