"""The tolerances the port's CUDA kernels are held to against their plain
PyTorch versions (`chip_smoke.py`, `tests/test_torch_cuda.py`).

- bf16 outputs: |kernel - plain| <= ATOL + RTOL·|plain|, element by
  element: one or two bf16 steps.
- f32 sums over many rows (weight, bias, norm, position and statistics
  gradients): ||kernel - plain|| <= REL·||plain|| + FLOOR·sqrt(numel),
  because their bf16 operands are summed in another order, partly by
  atomics; the floor admits sums that cancel to rounding noise (one key
  per query gives dS = 0).
"""
from __future__ import annotations

import torch

ATOL = RTOL = 2e-2
REL, FLOOR = 1e-2, 1e-4


def beyond(got, want) -> int:
    """Elements of `got` beyond ATOL + RTOL·|want|."""
    got, want = got.float(), want.float()
    return int(((got - want).abs() > ATOL + RTOL * want.abs()).sum())


def rel_error(got, want):
    """(||got - want||, the bound REL·||want|| + FLOOR·sqrt(numel))."""
    got, want = got.float(), want.float()
    return ((got - want).norm().item(),
            REL * want.norm().item() + FLOOR * want.numel() ** 0.5)
