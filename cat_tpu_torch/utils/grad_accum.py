"""Weight-aware gradient accumulation, `grad_accum_fold` (counterpart of
`cat_tpu/utils/grad_accum.py`).

Each micro-step hands over the gradients of the weighted SUM of its
per-sequence losses (in `p.grad`) and the micro-batch's total weight. The
accumulator adds both up; on the fold's last micro-step it divides the
summed gradient by the fold's total weight (the gradient of the weighted
mean over every sequence of the fold, as one large batch would give),
takes its global norm, clips it at `grad_clip`, sets the lr and steps the
optimizer, then starts a new fold. Between boundaries the parameters and
the optimizer state do not move. The accumulated sums are f32 tensors
beside the parameters, made at the first micro-step.
"""
from __future__ import annotations

import torch

from cat_tpu_torch.utils.scheduler import set_lr


class WeightedMultiSteps:
    def __init__(self, optimizer, params, fold: int, grad_clip: float = 0.0):
        self.optimizer = optimizer
        self.params = list(params)
        self.fold = int(fold)
        self.grad_clip = float(grad_clip)

    def update(self, state, weight, lr):
        """Adds the parameters' `.grad` (None counts as zero) and `weight`
        (a 0-dim tensor) to the fold of `state` (a `TrainState`). Returns
        (the global norm of the fold's mean gradient so far, whether this
        micro-step applied the update). Leaves every `.grad` as None."""
        if state.fold_sums is None:
            state.fold_sums = [torch.zeros_like(p, dtype=torch.float32)
                               for p in self.params]
            state.fold_weight = torch.zeros((), device=weight.device)
        acc = state.fold_sums
        for p, a in zip(self.params, acc):
            if p.grad is not None:
                a.add_(p.grad)
                p.grad = None
        state.fold_weight += weight
        state.fold_count += 1
        inv = 1.0 / torch.clamp_min(state.fold_weight, 1e-8)
        gnorm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(a * inv) for a in acc]))
        if state.fold_count < self.fold:
            return gnorm, False
        scale = inv
        if self.grad_clip > 0:
            scale = inv * torch.clamp_max(self.grad_clip / (gnorm + 1e-6), 1.0)
        for p, a in zip(self.params, acc):
            p.grad = (a * scale).to(p.dtype)
        set_lr(self.optimizer, lr)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        for a in acc:
            a.zero_()
        state.fold_weight.zero_()
        state.fold_count = 0
        return gnorm, True
