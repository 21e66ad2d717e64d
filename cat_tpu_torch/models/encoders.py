"""Encoders in PyTorch: the conformer (counterpart of `ConformerNet` in
`cat_tpu/models/encoders.py`), conv2d or VGG2L subsampling and the
time reduction, float32 (its default) or bfloat16, eval and training
mode (`.train()`: dropout and batch statistics, see `models/layers.py`),
the (B)LSTM encoder (counterpart of `LSTM` and its `LSTMStack`), the
TDNN stack `TDNN_NAS`, the JoinAP output layers (`JoinAPLinearEncoder`,
`JoinAPNonLinearEncoder`) over any registered encoder as their head, and
the token encoder `EmbeddingEncoder` of JSA-SPG (float32 conformer cells
over an embedding). Each encoder's `odim` is the width of its output
without the classifier (a JoinAP encoder's is its number of phones).

The JAX module's `remat`, `scan_layers`, `subsampling_remat` and
`remat_policy` are accepted and ignored: they change how training keeps
activations or how parameters are laid out, not the forward result
(`cat_tpu_torch.utils.from_jax` reads either parameter layout).
"""
from __future__ import annotations

import torch
from torch import nn

import numpy as np

from cat_tpu_torch.models.layers import (ConformerCell, Conv2dSubsampling,
                                         Dense, Dropout, TDNNLayer,
                                         VGG2LSubsampling, time_reduction)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ConformerNet(nn.Module):
    """conv2d (or VGG2L) subsampling -> linear -> N conformer cells, with a
    time reduction after cell `time_reduction_layer` when it is >= 0 (the
    mean of every `time_reduction_stride` frames; the later cells' masks
    from the reduced lengths) -> classifier. Computes in `dtype`,
    float32 by default as the JAX module: on the card every fused op then
    takes its f32 kernels.

    `idim` (the feature width, 80 mel bins in every recipe of the repo) is
    the port's own argument: the JAX module infers it from its input."""

    def __init__(self, num_cells=17, hdim=512, num_heads=8, kernel_size=32,
                 num_classes=0, dropout_rate=0.1, subsampling="conv2d",
                 time_reduction_layer=-1, time_reduction_stride=2,
                 use_batchnorm=True, with_head=True, dtype="float32",
                 subsampling_chunk=0, remat=False, remat_policy="",
                 scan_layers=False, subsampling_remat=True, idim=80,
                 generator=None):
        super().__init__()
        if dtype not in _DTYPES:
            raise ValueError(f"ConformerNet dtype must be one of "
                             f"{sorted(_DTYPES)}, got {dtype!r}")
        self.dtype = _DTYPES[dtype]
        self.idim = idim
        self.odim = hdim
        if subsampling == "conv2d":
            self.subsampling = Conv2dSubsampling(idim, hdim,
                                                 subsampling_chunk)
        elif subsampling == "vgg2l":
            self.subsampling = VGG2LSubsampling(idim, hdim)
        else:
            raise ValueError(f"ConformerNet subsampling must be 'conv2d' or "
                             f"'vgg2l', got {subsampling!r}")
        self.time_reduction_layer = time_reduction_layer
        self.time_reduction_stride = time_reduction_stride
        self.dropout = Dropout(dropout_rate)
        self.cells = nn.ModuleList(
            ConformerCell(hdim, num_heads, kernel_size,
                          dropout_rate=dropout_rate,
                          use_batchnorm=use_batchnorm)
            for _ in range(num_cells))
        self.classifier = (Dense(hdim, num_classes)
                           if with_head and num_classes > 0 else None)
        init_weights(self, generator)

    def forward(self, x, lengths, gen=None):
        """x (N, T, idim) float, lengths (N,) -> (logits (N, T', V) f32 or
        features (N, T', hdim) in the compute dtype, lengths (N,)).

        In training mode with dropout, `gen` (a CPU torch.Generator) gives
        every dropout site its seed words, in a fixed order."""
        if x.shape[-1] != self.idim:
            raise ValueError(f"ConformerNet expects {self.idim} features, got "
                             f"{x.shape[-1]}")
        h, lengths = self.subsampling(x, lengths, self.dtype)
        h = self.dropout(h, gen)
        for i, cell in enumerate(self.cells):
            h = cell(h, lengths, gen)
            if i == self.time_reduction_layer:
                h, lengths = time_reduction(h, lengths,
                                            self.time_reduction_stride)
        if self.classifier is not None:
            h = self.classifier(h.float(), torch.float32)
        return h, lengths


class EmbeddingEncoder(nn.Module):
    """Token-input encoder of JSA-SPG's P2G and G2P models (counterpart of
    the JAX `EmbeddingEncoder`): an embedding, `num_cells` conformer cells
    without subsampling, then the classifier; float32 throughout, as the
    JAX module computes (its embedding gives f32 and its cells default to
    f32). Its cells are built as the JAX module builds them, with the
    cell's default dropout rate 0: `dropout_rate` is accepted and, as in
    JAX, reaches no layer. Without batch normalisation (the default) the
    conv modules take JAX's unfused LayerNorm path; with it, at a width
    that is a multiple of 128, the fused conv-module stages. On the card
    every fused op runs its float32 route."""

    def __init__(self, vocab_size=0, num_cells=6, hdim=256, num_heads=4,
                 kernel_size=15, num_classes=0, dropout_rate=0.1,
                 with_head=True, use_batchnorm=False, generator=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.odim = hdim
        self.embed = nn.Embedding(vocab_size, hdim)
        self.cells = nn.ModuleList(
            ConformerCell(hdim, num_heads, kernel_size,
                          use_batchnorm=use_batchnorm)
            for _ in range(num_cells))
        self.classifier = (Dense(hdim, num_classes)
                           if with_head and num_classes > 0 else None)
        init_weights(self, generator)

    def forward(self, tokens, lengths, gen=None):
        """tokens (N, T) ints, lengths (N,) -> (logits (N, T, V) or
        features (N, T, hdim), float32; lengths)."""
        h = self.embed(tokens.long())
        for cell in self.cells:
            h = cell(h, lengths, gen)
        if self.classifier is not None:
            h = self.classifier(h, torch.float32)
        return h, lengths


def lstm_cell(wh, b, carry, xw):
    """One step of flax's `OptimizedLSTMCell`, the cell of the JAX
    package's LSTM encoder: xw = x·wi (precomputed for every frame), gates
    i, f, g, o of (h·wh + b) + xw, f = sigmoid(f) with no forget-gate
    offset (unlike the RNN-T predictor's `lstm_step`), c' = f·c + i·g,
    h' = o·tanh(c')."""
    c, h = carry
    i, f, g, o = ((h @ wh + b) + xw).chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return c, h


def flip_sequences(x, lengths):
    """flax's `flip_sequences` on (N, T, ...) x: each sequence's first
    lengths[n] frames reversed in place, its padding reversed behind them,
    so a scan over the result starts at the sequence's last valid frame.
    It is its own inverse."""
    T = x.shape[1]
    idx = (torch.arange(T - 1, -1, -1, device=x.device)[None, :]
           + lengths.to(x.device)[:, None]) % T
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return torch.gather(x, 1, idx)


class LSTMCellParams(nn.Module):
    """The parameters of one flax `OptimizedLSTMCell`, its per-gate
    kernels side by side in the gate order i, f, g, o: wi (din, 4H), the
    input kernels ii, if, ig, io (no bias); wh (H, 4H) and b (4H), the
    recurrent kernels and biases hi, hf, hg, ho."""

    def __init__(self, din, hdim):
        super().__init__()
        self.wi = nn.Parameter(torch.empty(din, 4 * hdim))
        self.wh = nn.Parameter(torch.empty(hdim, 4 * hdim))
        self.b = nn.Parameter(torch.zeros(4 * hdim))

    def scan(self, x):
        """The cell over every frame of x (N, T, din) from a zero carry ->
        (N, T, H) outputs."""
        N, T, _ = x.shape
        H = self.wh.shape[0]
        xw = x @ self.wi
        c = h = x.new_zeros(N, H)
        hs = []
        for t in range(T):
            c, h = lstm_cell(self.wh, self.b, (c, h), xw[:, t])
            hs.append(h)
        return torch.stack(hs, 1) if hs else x.new_zeros(N, 0, H)


class LSTM(nn.Module):
    """(B)LSTM encoder: `num_layers` layers of flax `OptimizedLSTMCell`s
    over the input features (no subsampling), dropout between layers, then
    the classifier. A layer's forward direction scans every frame from
    the first; its reverse direction (`nn.RNN(reverse=True,
    keep_order=True, seq_lengths=...)`) scans each sequence from its own
    last valid frame, its outputs put back in frame order; the two are
    concatenated. Frames past an utterance's length hold what the scan
    over the padding gives, which no loss reads. Computes in float32, as
    the JAX module does. `idim` is the port's own argument (the JAX module
    infers it)."""

    def __init__(self, hdim=512, num_layers=3, num_classes=0,
                 bidirectional=True, dropout_rate=0.1, with_head=True,
                 idim=80, generator=None):
        super().__init__()
        self.idim = idim
        self.bidirectional = bidirectional
        dirs = 2 if bidirectional else 1
        self.odim = dirs * hdim
        self.layers = nn.ModuleList(
            nn.ModuleList(LSTMCellParams(idim if i == 0 else dirs * hdim,
                                         hdim) for _ in range(dirs))
            for i in range(num_layers))
        self.dropout = Dropout(dropout_rate)
        self.classifier = (Dense(self.odim, num_classes)
                           if with_head and num_classes > 0 else None)
        init_weights(self, generator)

    def forward(self, x, lengths, gen=None):
        """x (N, T, idim), lengths (N,) -> (logits (N, T, V) or features
        (N, T, odim), float32; lengths). In training mode with dropout,
        `gen` (a CPU torch.Generator) seeds the dropout between layers."""
        if x.shape[-1] != self.idim:
            raise ValueError(f"LSTM expects {self.idim} features, got "
                             f"{x.shape[-1]}")
        h = x.float()
        for i, cells in enumerate(self.layers):
            outs = [cells[0].scan(h)]
            if self.bidirectional:
                outs.append(flip_sequences(
                    cells[1].scan(flip_sequences(h, lengths)), lengths))
            h = torch.cat(outs, -1)
            if i < len(self.layers) - 1:
                h = self.dropout(h, gen)
        if self.classifier is not None:
            h = self.classifier(h, torch.float32)
        return h, lengths


class TDNN_NAS(nn.Module):
    """The NAS-derived TDNN stack (counterpart of the JAX `TDNN_NAS`):
    seven `TDNNLayer`s of (half_context, dilation, stride) (1, 1, 1),
    (1, 1, 1), (1, 1, 2), (1, 1, 1), (1, 1, 1), (1, 3, 1), (1, 3, 1), each
    followed by dropout, then the classifier; float32 throughout. The
    dropout is the port's `Dropout` (row 1's kernel on the card), drawn
    over the (N, hdim, T) layout the convolutions keep, where the JAX
    module takes flax's `nn.Dropout`: the two agree at rate 0 only. `idim`
    is the port's own argument (the JAX module infers it)."""

    SPECS = ((1, 1, 1), (1, 1, 1), (1, 1, 2), (1, 1, 1), (1, 1, 1),
             (1, 3, 1), (1, 3, 1))

    def __init__(self, hdim=640, num_classes=0, dropout_rate=0.5,
                 with_head=True, idim=80, generator=None):
        super().__init__()
        self.idim = idim
        self.odim = hdim
        self.layers = nn.ModuleList(
            TDNNLayer(idim if i == 0 else hdim, hdim, hc, dil, stride)
            for i, (hc, dil, stride) in enumerate(self.SPECS))
        self.dropout = Dropout(dropout_rate)
        self.classifier = (Dense(hdim, num_classes)
                           if with_head and num_classes > 0 else None)
        init_weights(self, generator)

    def forward(self, x, lengths, gen=None):
        """x (N, T, idim), lengths (N,) -> (logits (N, T', V) or features
        (N, T', hdim), float32; lengths), T' = ceil(T / 2)."""
        if x.shape[-1] != self.idim:
            raise ValueError(f"TDNN_NAS expects {self.idim} features, got "
                             f"{x.shape[-1]}")
        h = x.float().transpose(1, 2).contiguous()
        for layer in self.layers:
            h, lengths = layer(h, lengths)
            h = self.dropout(h, gen)
        h = h.transpose(1, 2)
        if self.classifier is not None:
            h = self.classifier(h, torch.float32)
        return h, lengths


class JoinAPLinearEncoder(nn.Module):
    """The JoinAP output layer over a head encoder (counterpart of the JAX
    `JoinAPLinearEncoder`): logits = head(x) @ (A·P)ᵀ, P (Np, Dp) the fixed
    phonological matrix of `pv_path` (float32), A a learned Dense (Dp ->
    H), H the head's output width. The product runs in float32 (a
    bfloat16 head times the float32 A·P promotes to float32 in JAX). P is
    a non-persistent buffer, outside the state_dict as it is outside the
    JAX module's params, so checkpoints of both packages hold the same
    weights. The head is any registered encoder, built with
    `enc_head_kwargs` and no classifier; `num_classes`, when given, must
    equal Np. `with_head` is accepted and ignored, as in JAX: the output
    is always the logits."""

    def __init__(self, pv_path="", enc_head_type="LSTM",
                 enc_head_kwargs=None, num_classes=0, with_head=True,
                 generator=None):
        super().__init__()
        from cat_tpu_torch.models import get_encoder

        P = np.load(pv_path).astype(np.float32)
        if num_classes and num_classes != P.shape[0]:
            raise ValueError(f"{type(self).__name__}: num_classes "
                             f"{num_classes} != {P.shape[0]} phones of "
                             f"{pv_path} (P {P.shape})")
        kw = dict(enc_head_kwargs or {})
        kw["with_head"] = False
        kw.pop("num_classes", None)
        self.enc_head = get_encoder(enc_head_type)(**kw, generator=generator)
        self.register_buffer("P", torch.from_numpy(P), persistent=False)
        self.odim = P.shape[0]
        self._build_ap(P.shape[1], self.enc_head.odim, generator)

    def _build_ap(self, dp, h, generator):
        self.A = Dense(dp, h)
        init_weights(self.A, generator)

    def ap(self):
        """A·P (Np, H) in float32."""
        return self.A(self.P, torch.float32)

    def forward(self, x, lengths, gen=None):
        """x (N, T, idim), lengths (N,) -> (logits (N, T', Np) float32,
        lengths); `gen` seeds the head's dropout in training mode."""
        h, lengths = self.enc_head(x, lengths, gen)
        return h.float() @ self.ap().t(), lengths


class JoinAPNonLinearEncoder(JoinAPLinearEncoder):
    """The nonlinear JoinAP layer (counterpart of the JAX
    `JoinAPNonLinearEncoder`): A·P is A2(sigmoid(A1·P)), A1 (Dp ->
    ap_hdim) and A2 (ap_hdim -> H)."""

    def __init__(self, pv_path="", ap_hdim=512, enc_head_type="LSTM",
                 enc_head_kwargs=None, num_classes=0, with_head=True,
                 generator=None):
        self.ap_hdim = ap_hdim
        super().__init__(pv_path, enc_head_type, enc_head_kwargs,
                         num_classes, with_head, generator)

    def _build_ap(self, dp, h, generator):
        self.A1 = Dense(dp, self.ap_hdim)
        self.A2 = Dense(self.ap_hdim, h)
        init_weights(self.A1, generator)
        init_weights(self.A2, generator)

    def ap(self):
        return self.A2(torch.sigmoid(self.A1(self.P, torch.float32)),
                       torch.float32)


@torch.no_grad()
def init_weights(model, generator=None):
    """Random weights drawn on the CPU from `generator`: kernels normal
    with variance 1/fan_in, embeddings with variance 1/width, biases zero,
    norms identity, an LSTM cell's
    recurrent kernel orthogonal per gate (the JAX package's defaults,
    without truncation)."""
    for mod in model.modules():
        if isinstance(mod, nn.Embedding):
            w = mod.weight
            w.copy_(torch.randn(w.shape, generator=generator)
                    / w.shape[1] ** 0.5)
        elif isinstance(mod, LSTMCellParams):
            w = mod.wi
            w.copy_(torch.randn(w.shape, generator=generator)
                    / w.shape[0] ** 0.5)
            H = mod.wh.shape[0]
            for k in range(4):
                q, _ = torch.linalg.qr(torch.randn(H, H, generator=generator))
                mod.wh[:, k * H:(k + 1) * H] = q
            mod.b.zero_()
        elif isinstance(mod, Dense):
            w = mod.kernel
            w.copy_(torch.randn(w.shape, generator=generator)
                    / w.shape[0] ** 0.5)
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d)):
            w = mod.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator) / fan_in ** 0.5)
            mod.bias.zero_()
