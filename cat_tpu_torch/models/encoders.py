"""Encoders in PyTorch: the conformer (counterpart of `ConformerNet` in
`cat_tpu/models/encoders.py`), conv2d subsampling, eval and training
mode (`.train()`: dropout and batch statistics, see `models/layers.py`).

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


@torch.no_grad()
def init_weights(model, generator=None):
    """Random weights drawn on the CPU from `generator`: kernels normal
    with variance 1/fan_in, biases zero, norms identity (the JAX package's
    defaults, without truncation)."""
    for mod in model.modules():
        if isinstance(mod, Dense):
            w = mod.kernel
            w.copy_(torch.randn(w.shape, generator=generator)
                    / w.shape[0] ** 0.5)
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d)):
            w = mod.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator) / fan_in ** 0.5)
            mod.bias.zero_()
