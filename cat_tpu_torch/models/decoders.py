"""RNN-T predictors, neural LMs and the P2G decoder in PyTorch
(counterparts of `LSTMPredictor`, `Embedding`, `CausalTransformer`,
`TransformerDecoder`, `ZeroDecoder` and `SyllableEnhancedLSTM` in
`cat_tpu/models/decoders.py`).

API as the JAX modules: `forward(tokens, lengths, gen=None)` -> (hidden
or logits, lengths) for full sequences; `init_state(batch, device)` and
`step(tokens, state)` -> (hidden or logits, state) for incremental
decoding (not the transformer's). The LSTM cell is written out with plain
matrix products, including the JAX cell's forget-gate bias of +1.0 inside
the sigmoid (which `torch.nn.LSTM` lacks), and the full-sequence pass runs
the same cell function as `step`, so the two give identical outputs.
Everything runs in float32, as the JAX modules do. With `with_head` and
`num_classes` > 0 a module is an LM and returns logits: a `classifier`
(an `Embedding`'s `head`), or, `tied`, the hidden state times the
embedding's transpose. `CausalTransformer` follows flax's layers:
LayerNorm epsilon 1e-6, tanh-approximated GELU, masked scores filled with
the float32 minimum (a query whose keys are all masked attends uniformly)
and dropout of the attention probabilities with one mask shared by the
batch and the heads; `TransformerDecoder` adds cross attention on an
encoder's output with the same semantics (flax's
`MultiHeadDotProductAttention`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cat_tpu_torch.models.layers import LN_EPS, Dense, Dropout, drop_args
from cat_tpu_torch.ops.dropout import dropout_mask


def _normal_(w, generator, std):
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator) * std)


def _dense(din, dout, generator):
    """A `Dense` with a normal kernel of variance 1/din and a zero bias."""
    d = Dense(din, dout)
    _normal_(d.kernel, generator, din ** -0.5)
    return d


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
    """Embedding (+ a syllable embedding) -> LSTM stack, dropout between
    layers -> the LM head, if any."""

    def __init__(self, vocab_size, hdim=640, num_layers=1, edim=0,
                 num_classes=0, dropout_rate=0.0, with_head=False,
                 tied=False, syllable_converter=None, generator=None):
        super().__init__()
        edim = edim or hdim
        self.hdim = hdim
        self.num_layers = num_layers
        self.has_head = bool(with_head and num_classes > 0)
        self.tied = bool(tied)
        if self.has_head and self.tied and edim != hdim:
            raise ValueError(f"a tied LM head needs edim == hdim, got "
                             f"{edim} and {hdim}")
        self.embed = nn.Embedding(vocab_size, edim)
        self.syl_embed = None
        if syllable_converter is not None:
            conv = torch.as_tensor(list(syllable_converter), dtype=torch.long)
            self.register_buffer("syllable_of", conv, persistent=False)
            self.syl_embed = nn.Embedding(int(conv.max()) + 1, edim)
        for i in range(num_layers):
            din = edim if i == 0 else hdim
            self.register_parameter(f"lstm_{i}_wx", nn.Parameter(
                torch.empty(din, 4 * hdim)))
            self.register_parameter(f"lstm_{i}_wh", nn.Parameter(
                torch.empty(hdim, 4 * hdim)))
            self.register_parameter(f"lstm_{i}_b", nn.Parameter(
                torch.zeros(4 * hdim)))
        self.dropout = Dropout(dropout_rate)
        self.classifier = (Dense(hdim, num_classes)
                           if self.has_head and not self.tied else None)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Random weights drawn on the CPU from `generator`: the embeddings
        normal with variance 1/edim, wx and the classifier normal with
        variance 1/fan_in, wh orthogonal, biases zero (the JAX package's
        initialisers, without truncation or Glorot scaling)."""
        for emb in (self.embed, self.syl_embed):
            if emb is not None:
                w = emb.weight
                w.copy_(torch.randn(w.shape, generator=generator)
                        / w.shape[1] ** 0.5)
        for i in range(self.num_layers):
            wx = getattr(self, f"lstm_{i}_wx")
            wx.copy_(torch.randn(wx.shape, generator=generator)
                     / wx.shape[0] ** 0.5)
            wh = getattr(self, f"lstm_{i}_wh")
            q, _ = torch.linalg.qr(torch.randn(wh.shape[1], wh.shape[0],
                                               generator=generator))
            wh.copy_(q.T)
            getattr(self, f"lstm_{i}_b").zero_()
        if self.classifier is not None:
            k = self.classifier.kernel
            k.copy_(torch.randn(k.shape, generator=generator)
                    / k.shape[0] ** 0.5)
            self.classifier.bias.zero_()

    def _layer(self, i):
        return (getattr(self, f"lstm_{i}_wx"), getattr(self, f"lstm_{i}_wh"),
                getattr(self, f"lstm_{i}_b"))

    def _embed(self, tokens):
        tokens = tokens.long()
        x = self.embed(tokens)
        if self.syl_embed is not None:
            x = x + self.syl_embed(self.syllable_of[tokens])
        return x

    def _head(self, h):
        if not self.has_head:
            return h
        if self.tied:
            return h @ self.embed.weight.T
        return self.classifier(h, torch.float32)

    def forward(self, tokens, lengths=None, gen=None):
        """tokens (N, U) -> (hidden (N, U, hdim), or the LM's logits (N, U,
        num_classes), f32; lengths)."""
        x = self._embed(tokens)
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
        return self._head(x), lengths

    def init_state(self, batch_size, device=None):
        return tuple((torch.zeros(batch_size, self.hdim, device=device),
                      torch.zeros(batch_size, self.hdim, device=device))
                     for _ in range(self.num_layers))

    def step(self, tokens, state):
        """One decode step: tokens (N,) -> (out (N, hdim) or logits, new
        state)."""
        x = self._embed(tokens)
        new_state = []
        for i, st in enumerate(state):
            st, x = lstm_step(*self._layer(i), st, x)
            new_state.append(st)
        return self._head(x), tuple(new_state)


def SyllableEnhancedLSTM(vocab_size, syllable_converter, **kw):
    """An `LSTMPredictor` whose embedding is the character's plus its
    syllable's (`syllable_converter[token]`)."""
    return LSTMPredictor(vocab_size=vocab_size,
                         syllable_converter=tuple(syllable_converter), **kw)


class Embedding(nn.Module):
    """Context-1 embedding predictor, with a dense LM head (`head`) when
    `with_head` and num_classes > 0."""

    def __init__(self, vocab_size, hdim=256, num_classes=0, with_head=False,
                 generator=None):
        super().__init__()
        self.hdim = hdim
        self.embed = nn.Embedding(vocab_size, hdim)
        _normal_(self.embed.weight, generator, hdim ** -0.5)
        self.head = (_dense(hdim, num_classes, generator)
                     if with_head and num_classes > 0 else None)

    def forward(self, tokens, lengths=None, gen=None):
        h = self.embed(tokens.long())
        if self.head is not None:
            h = self.head(h, torch.float32)
        return h, lengths

    def init_state(self, batch_size, device=None):
        return ()

    def step(self, tokens, state):
        return self.forward(tokens)[0], state


def attend(m, x, kv, mask, gen):
    """flax's `MultiHeadDotProductAttention` on the dense layers q, k, v
    and out of module `m` (its `num_heads` and `dropout_rate`): queries
    from x (N, U, D), keys and values from kv (N, S, D'); q/sqrt(Dh)·k,
    the scores where `mask` (broadcast to (N, H, U, S)) is false at the
    float32 minimum, softmax, dropout of the probabilities (one (U, S) mask
    for the batch and the heads, `dropout_mask`: one launch on the card),
    times v, the output projection."""
    f32 = torch.float32
    N, U, D = x.shape
    S, H = kv.shape[1], m.num_heads
    heads = lambda t, L: t.view(N, L, H, D // H).transpose(1, 2)
    q = heads(m.q(x, f32), U) / math.sqrt(D // H)
    s = q @ heads(m.k(kv, f32), S).transpose(-1, -2)     # (N, H, U, S)
    if mask is not None:
        s = s.masked_fill(~mask, torch.finfo(f32).min)
    p = torch.softmax(s, -1)
    rate, seed = drop_args(m, m.dropout_rate, gen)
    if rate > 0.0:
        p = p * dropout_mask(seed, 0, U, S, rate, x.device)[0]
    o = (p @ heads(m.v(kv, f32), S)).transpose(1, 2).reshape(N, U, D)
    return m.out(o, f32)


class _Block(nn.Module):
    """One pre-LN block of `CausalTransformer`: x + attn(ln1(x)), then
    x + dropout(ff2(gelu(ff1(ln2(x)))))."""

    def __init__(self, hdim, num_heads, ff_dim, dropout_rate, generator):
        super().__init__()
        if hdim % num_heads:
            raise ValueError(f"hdim {hdim} is no multiple of {num_heads} "
                             "heads")
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.ln1 = nn.LayerNorm(hdim, eps=LN_EPS)
        self.q, self.k, self.v, self.out = (_dense(hdim, hdim, generator)
                                            for _ in range(4))
        self.ln2 = nn.LayerNorm(hdim, eps=LN_EPS)
        self.ff1 = _dense(hdim, ff_dim, generator)
        self.ff2 = _dense(ff_dim, hdim, generator)
        self.dropout = Dropout(dropout_rate)

    def attention(self, x, mask, gen):
        """flax's SelfAttention (`attend` with kv = x)."""
        return attend(self, x, x, mask, gen)

    def feed_forward(self, h, gen):
        f = F.gelu(self.ff1(self.ln2(h), torch.float32), approximate="tanh")
        return h + self.dropout(self.ff2(f, torch.float32), gen)

    def forward(self, h, mask, gen):
        return self.feed_forward(h + self.attention(self.ln1(h), mask, gen),
                                 gen)


class CausalTransformer(nn.Module):
    """Causal transformer LM (GPT-2 style): learned positions, pre-LN
    blocks, a causal and length mask, GELU feed-forward, a final
    LayerNorm; the head tied to the embedding when num_classes ==
    vocab_size and `tied`, else a dense `head`."""

    def __init__(self, vocab_size, hdim=512, num_layers=6, num_heads=8,
                 ff_dim=2048, max_len=2048, num_classes=0, dropout_rate=0.1,
                 with_head=True, tied=True, generator=None):
        super().__init__()
        self.hdim = hdim
        self.embed = nn.Embedding(vocab_size, hdim)
        _normal_(self.embed.weight, generator, hdim ** -0.5)
        self.pos_embed = nn.Parameter(torch.empty(max_len, hdim))
        _normal_(self.pos_embed, generator, 0.02)
        self.dropout = Dropout(dropout_rate)
        self.blocks = nn.ModuleList(
            _Block(hdim, num_heads, ff_dim, dropout_rate, generator)
            for _ in range(num_layers))
        self.ln_f = nn.LayerNorm(hdim, eps=LN_EPS)
        has_head = with_head and num_classes > 0
        self.tied = has_head and tied and num_classes == vocab_size
        self.head = (_dense(hdim, num_classes, generator)
                     if has_head and not self.tied else None)

    def forward(self, tokens, lengths=None, gen=None):
        """tokens (N, U) -> (logits (N, U, num_classes), or the hidden
        state without a head, f32; lengths)."""
        N, U = tokens.shape
        h = self.embed(tokens.long()) + self.pos_embed[None, :U]
        h = self.dropout(h, gen)
        mask = torch.ones(U, U, dtype=torch.bool,
                          device=tokens.device).tril()[None, None]
        if lengths is not None:
            valid = torch.arange(U, device=tokens.device)[None, :] \
                < lengths.to(tokens.device)[:, None]
            mask = mask & valid[:, None, None, :]
        for block in self.blocks:
            h = block(h, mask, gen)
        h = self.ln_f(h)
        if self.tied:
            h = h @ self.embed.weight.T
        elif self.head is not None:
            h = self.head(h, torch.float32)
        return h, lengths


class _CrossAttention(nn.Module):
    """The dense layers of one cross attention (`attend` on memory)."""

    def __init__(self, hdim, num_heads, dropout_rate, generator):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.q, self.k, self.v, self.out = (_dense(hdim, hdim, generator)
                                            for _ in range(4))

    def forward(self, x, memory, mask, gen):
        return attend(self, x, memory, mask, gen)


class _DecoderBlock(_Block):
    """`_Block` with cross attention between its self attention and its
    feed-forward: x + cross(lnx(x), memory), when memory is given."""

    def __init__(self, hdim, num_heads, ff_dim, dropout_rate, generator):
        super().__init__(hdim, num_heads, ff_dim, dropout_rate, generator)
        self.lnx = nn.LayerNorm(hdim, eps=LN_EPS)
        self.cross = _CrossAttention(hdim, num_heads, dropout_rate, generator)

    def forward(self, h, mask, gen, memory=None, cross_mask=None):
        h = h + self.attention(self.ln1(h), mask, gen)
        if memory is not None:
            h = h + self.cross(self.lnx(h), memory, cross_mask, gen)
        return self.feed_forward(h, gen)


class TransformerDecoder(nn.Module):
    """The P2G decoder (BERT style, optionally causal): a learned position
    table, pre-LN blocks of self attention (length mask on queries and
    keys, and the causal mask), cross attention on `memory` (the keys
    masked by `memory_lengths`) when it is given, a GELU feed-forward with
    dropout on its output, a final LayerNorm and a dense `head`. The cross
    layers are built up front (JAX makes them at its first call with
    memory, as P2G's init does)."""

    def __init__(self, vocab_size, hdim=512, num_layers=6, num_heads=8,
                 ff_dim=2048, max_len=2048, num_classes=0, dropout_rate=0.1,
                 with_head=True, causal=False, generator=None):
        super().__init__()
        self.causal = causal
        self.embed = nn.Embedding(vocab_size, hdim)
        _normal_(self.embed.weight, generator, hdim ** -0.5)
        self.pos_embed = nn.Parameter(torch.empty(max_len, hdim))
        _normal_(self.pos_embed, generator, 0.02)
        self.blocks = nn.ModuleList(
            _DecoderBlock(hdim, num_heads, ff_dim, dropout_rate, generator)
            for _ in range(num_layers))
        self.ln_f = nn.LayerNorm(hdim, eps=LN_EPS)
        self.head = (_dense(hdim, num_classes, generator)
                     if with_head and num_classes > 0 else None)

    def forward(self, tokens, lengths=None, memory=None, memory_lengths=None,
                gen=None):
        """tokens (N, U) -> (logits (N, U, num_classes), or the hidden
        state without a head, f32; lengths)."""
        N, U = tokens.shape
        dev = tokens.device
        h = self.embed(tokens.long()) + self.pos_embed[None, :U]
        mask = None
        if lengths is not None:
            valid = torch.arange(U, device=dev)[None, :] \
                < lengths.to(dev)[:, None]
            mask = valid[:, None, None, :] & valid[:, None, :, None]
        if self.causal:
            tri = torch.ones(U, U, dtype=torch.bool, device=dev).tril()
            mask = tri[None, None] if mask is None else mask & tri
        cross_mask = None
        if memory is not None and memory_lengths is not None:
            cross_mask = (torch.arange(memory.shape[1], device=dev)[None, :]
                          < memory_lengths.to(dev)[:, None])[:, None, None]
        for block in self.blocks:
            h = block(h, mask, gen, memory, cross_mask)
        h = self.ln_f(h)
        if self.head is not None:
            h = self.head(h, torch.float32)
        return h, lengths


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
