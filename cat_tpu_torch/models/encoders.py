"""Encoders in PyTorch: the conformer (counterpart of `ConformerNet` in
`cat_tpu/models/encoders.py`), conv2d subsampling, eval and training
mode (`.train()`: dropout and batch statistics, see `models/layers.py`),
and the (B)LSTM encoder (counterpart of `LSTM` and its `LSTMStack`).
Each encoder's `odim` is the width of its output without the classifier.

The JAX module's `remat`, `scan_layers`, `subsampling_remat` and
`remat_policy` are accepted and ignored: they change how training keeps
activations or how parameters are laid out, not the forward result
(`cat_tpu_torch.utils.from_jax` reads either parameter layout).
"""
from __future__ import annotations

import torch
from torch import nn

from cat_tpu_torch.models.layers import (ConformerCell, Conv2dSubsampling,
                                         Dense, Dropout)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _not_ported(what):
    return NotImplementedError(f"ConformerNet {what} is not ported yet; "
                               "see ROADMAP.md")


class ConformerNet(nn.Module):
    """conv2d subsampling -> linear -> N conformer cells -> classifier.

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
        if subsampling != "conv2d":
            raise _not_ported(f"subsampling={subsampling!r}")
        if time_reduction_layer >= 0:
            raise _not_ported("time reduction")
        if not use_batchnorm:
            raise _not_ported("use_batchnorm=False")
        if dtype not in _DTYPES:
            raise ValueError(f"ConformerNet dtype must be one of "
                             f"{sorted(_DTYPES)}, got {dtype!r}")
        self.dtype = _DTYPES[dtype]
        self.idim = idim
        self.odim = hdim
        self.subsampling = Conv2dSubsampling(idim, hdim, subsampling_chunk)
        self.dropout = Dropout(dropout_rate)
        self.cells = nn.ModuleList(
            ConformerCell(hdim, num_heads, kernel_size,
                          dropout_rate=dropout_rate)
            for _ in range(num_cells))
        self.classifier = (Dense(hdim, num_classes)
                           if with_head and num_classes > 0 else None)
        init_weights(self, generator)

    def forward(self, x, lengths, gen=None):
        """x (N, T, idim) float, lengths (N,) -> (logits (N, T', V) f32 or
        features (N, T', hdim) in the compute dtype, lengths (N,)).

        In training mode with dropout, `gen` (a CPU torch.Generator) gives
        every dropout site its seed words, in a fixed order."""
        if x.is_cuda and self.dtype != torch.bfloat16:
            raise NotImplementedError(
                'the CUDA kernels take bfloat16 activations: set the '
                'encoder\'s dtype to "bfloat16" (float32 on the card is not '
                'ported yet; see ROADMAP.md)')
        if x.shape[-1] != self.idim:
            raise ValueError(f"ConformerNet expects {self.idim} features, got "
                             f"{x.shape[-1]}")
        h, lengths = self.subsampling(x, lengths, self.dtype)
        h = self.dropout(h, gen)
        for cell in self.cells:
            h = cell(h, lengths, gen)
        if self.classifier is not None:
            h = self.classifier(h.float(), torch.float32)
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


@torch.no_grad()
def init_weights(model, generator=None):
    """Random weights drawn on the CPU from `generator`: kernels normal
    with variance 1/fan_in, biases zero, norms identity, an LSTM cell's
    recurrent kernel orthogonal per gate (the JAX package's defaults,
    without truncation)."""
    for mod in model.modules():
        if isinstance(mod, LSTMCellParams):
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
