"""Dropout: the Philox keep-mask of `cat_tpu_torch/csrc/common.cuh`, its
plain PyTorch twin, and the standalone dropout op.

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

`dropout` is the standalone op (counterpart of `fused_dropout` in
`cat_tpu/ops/dropout_pallas.py`, whose TPU kernels `_kernel`/`_kernel3`
it replaces): a `torch.autograd.Function` whose forward and backward both
call `dropout_apply` with the same seed, so the backward applies the
forward's mask to the cotangent and no mask is stored. `dropout_apply`
launches `cat_tpu_torch/csrc/dropout.cu` on a CUDA tensor and takes
`dropout_reference` on a CPU tensor; kernel and plain version agree bit
for bit.
"""
from __future__ import annotations

import torch

from cat_tpu_torch import _build

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


def dropout_apply(x, rate: float, seed, stream: int = 0):
    """x times its keep factor (`dropout_reference`). Rate 0 returns x and
    launches nothing. A CPU tensor takes `dropout_reference`; a CUDA
    tensor launches the kernel, which takes contiguous bf16 or f32, or
    raises."""
    if rate <= 0.0:
        return x
    if x.device.type == "cpu":
        return dropout_reference(x, rate, seed, stream)
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or not x.is_contiguous() or x.dim() == 0:
        raise ValueError(f"dropout: the kernel takes contiguous bfloat16 or "
                         f"float32 CUDA tensors, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    C = x.shape[-1]
    R = x.numel() // max(C, 1)
    if C % 4 == 0 and x.data_ptr() % (4 * x.element_size()):
        raise ValueError("dropout: with rows of a multiple of 4 values the "
                         "kernel takes tensors aligned to 4 values")
    drop, inv = kernel_args(rate, seed)
    out = torch.empty_like(x)
    err = _build.load("dropout", _ENTRIES).dropout_fwd(
        x.data_ptr(), out.data_ptr(), R, C, int(x.dtype == torch.float32),
        int(stream), *drop, inv,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dropout")
    dropout_apply.launches += 1
    return out


dropout_apply.launches = 0
_ENTRIES = {"dropout_fwd": (2, 7, 1)}


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, seed, stream):
        ctx.cfg = (rate, seed, stream)
        return dropout_apply(x, rate, seed, stream)

    @staticmethod
    def backward(ctx, g):
        return dropout_apply(g.contiguous(), *ctx.cfg), None, None, None


def dropout(x, rate: float, seed, stream: int = 0):
    """Dropout of x (..., C) with the Philox mask of (seed, stream) over the
    rows of the flattened leading dims; the identity at rate 0.
    Differentiable in x: the backward re-draws the same mask."""
    if rate <= 0.0:
        return x
    return _Dropout.apply(x, float(rate), seed, int(stream))
