"""Training state (counterpart of `TrainState` in
`cat_tpu/utils/manager.py`). The `Manager` loop is not ported yet
(ROADMAP.md)."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    """The model (parameters and running statistics), its optimizer (with
    the Adam moments), the number of steps taken and of steps skipped by
    the NaN/Inf guard."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    skipped: int = 0
