"""Dropout bits: the plain PyTorch twin of the Philox keep-mask in
`cat_tpu_torch/csrc/common.cuh`.

A keep decision is a pure function of (seed, stream, plane, row, column):
Philox-4x32-10 with key = the two 32-bit seed words and counter =
(column // 4, row, plane, stream); output word i decides column
4 * (column // 4) + i. A value is kept iff its word >= thr, with
thr = min(floor(rate * 2^32), 2^32 - 1) as uint32 (the TPU kernels' rule,
`cat_tpu/ops/attention_pallas.py` `_dropout_keep`/`_thr`), and kept
values are scaled by 1 / (1 - rate). Because the mask does not depend on
any tiling, the forward and backward kernels draw the same mask, and this
module reproduces it bit for bit on any device: the arithmetic is int64,
with the 32 x 32-bit products split so that nothing overflows.

Seeds are two 32-bit words per dropout call, drawn from an explicit
`torch.Generator` (`draw_seed`). The TPU's hardware bits cannot be
matched, so tests across the two packages run at rate 0.
"""
from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def threshold(rate: float) -> int:
    """The keep threshold as an unsigned 32-bit integer."""
    return min(int(rate * 4294967296.0), 4294967295)


def as_int32(v: int) -> int:
    """An unsigned 32-bit word as the signed int a C `int` receives."""
    return v - (1 << 32) if v >= 1 << 31 else v


def kernel_args(rate: float, seed):
    """The dropout arguments of a CUDA kernel: ([seed0, seed1, thr] as the
    signed ints a C `int` receives, inv = 1 / (1 - rate)); rate 0 gives
    thr 0, which the kernels read as no dropout."""
    if rate <= 0.0:
        return [0, 0, 0], 1.0
    if seed is None:
        raise ValueError("dropout rate > 0 needs a seed")
    return ([as_int32(int(w) & 0xFFFFFFFF) for w in seed]
            + [as_int32(threshold(rate))], 1.0 / (1.0 - rate))


def draw_seed(gen: torch.Generator) -> tuple:
    """Two 32-bit seed words from `gen` (a CPU generator: no device sync)."""
    w = torch.randint(0, 1 << 32, (2,), generator=gen, dtype=torch.int64)
    return int(w[0]), int(w[1])


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit halves of a * m, a an int64 tensor of uint32 values."""
    p0 = a * (m & 0xFFFF)          # < 2^48
    p1 = a * (m >> 16)             # < 2^48
    t = p0 + ((p1 & 0xFFFF) << 16)
    return (t >> 32) + (p1 >> 16), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 on broadcastable int64 tensors of uint32 values."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def keep_mask(seed, stream: int, planes: int, rows: int, cols: int,
              rate: float, device=None) -> torch.Tensor:
    """(planes, rows, cols) bool keep mask of the given stream."""
    if rate <= 0.0:
        return torch.ones(planes, rows, cols, dtype=torch.bool, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    groups = (cols + 3) // 4
    g = torch.arange(groups, **i64)[None, None, :]
    r = torch.arange(rows, **i64)[None, :, None]
    a = torch.arange(planes, **i64)[:, None, None]
    s = torch.full((), stream, **i64)
    zero = torch.zeros((planes, rows, groups), **i64)
    words = philox4x32_10(g + zero, r + zero, a + zero, s + zero,
                          int(seed[0]) & _MASK32, int(seed[1]) & _MASK32)
    bits = torch.stack(words, dim=-1).reshape(planes, rows, 4 * groups)
    return bits[..., :cols] >= threshold(rate)


def dropout_scale(seed, stream: int, planes: int, rows: int, cols: int,
                  rate: float, device=None) -> torch.Tensor:
    """The f32 factor a value is multiplied by: 1 / (1 - rate) where kept,
    0 where dropped."""
    keep = keep_mask(seed, stream, planes, rows, cols, rate, device)
    return keep.float() * (1.0 / (1.0 - rate))


def dropout_reference(x, rate: float, seed, stream: int = 0):
    """Plain dropout of x (..., C), rows = the flattened leading dims."""
    if rate <= 0.0:
        return x
    C = x.shape[-1]
    R = x.numel() // max(C, 1)
    f = dropout_scale(seed, stream, 1, R, C, rate, x.device)
    return (x.float() * f.view(x.shape)).to(x.dtype)
