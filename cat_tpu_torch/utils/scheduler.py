"""LR scheduler and optimizer building (counterpart of
`cat_tpu/utils/scheduler.py`, the pieces the crf recipes use).

The scheduler is a host-side state machine that owns a scalar `lr`; the
train step receives it each step, as in the JAX package. Only the Noam
schedule (with its base classes) and the Adam/AdamW optimizers are
ported; the other schedulers are queued in ROADMAP.md.

`torch.optim.Adam(betas, eps=1e-8)` makes the update of optax's `adam`:
bias-corrected moments m^ = m / (1 - b1^t), v^ = v / (1 - b2^t) and the
step lr * m^ / (sqrt(v^) + eps), eps outside the root. `AdamW` decays
the weights as optax's `adamw` does, p -= lr * (update + wd * p), with
optax's default wd = 1e-4.
"""
from __future__ import annotations

import math

import torch


def build_optimizer(cfg: dict, params):
    """cfg: {"type": "Adam"|"AdamW", "kwargs": {"lr", "betas", ...}}.
    Returns (optimizer over `params`, initial lr)."""
    name = cfg["type"].lower()
    kwargs = dict(cfg.get("kwargs", {}))
    lr = kwargs.pop("lr", 1e-3)
    kwargs.pop("zeroredundancy", None)
    betas = tuple(kwargs.pop("betas", (0.9, 0.999)))
    eps = kwargs.pop("eps", 1e-8)
    if name == "adam" and "weight_decay" in kwargs:
        name = "adamw"  # as the JAX package rebuilds adam + decay
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, **kwargs)
    elif name == "adamw":
        kwargs.setdefault("weight_decay", 1e-4)
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, **kwargs)
    else:
        raise NotImplementedError(f"optimizer {cfg['type']!r} is not ported "
                                  "yet; see ROADMAP.md")
    return opt, lr


def set_lr(optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


class Scheduler:
    """Base: the current lr."""

    def __init__(self, lr_init: float):
        self.lr = float(lr_init)
        self.init_lr = float(lr_init)

    def update_lr_step(self, n_step: int):
        return None


class SchedulerFixedStop(Scheduler):
    """Run exactly stop_step steps (the Manager loop, not ported yet, reads
    when to stop)."""

    def __init__(self, lr_init, stop_step):
        super().__init__(lr_init)
        self.stop_step = int(stop_step)


class SchedulerNoam(SchedulerFixedStop):
    """lr = peak_factor / sqrt(dim_model) * min(1/sqrt(n), n/warmup^1.5)."""

    def __init__(self, lr_init=None, dim_model=512, warmup_step=4000,
                 stop_step=100000, peak_factor=1.0):
        ref = peak_factor / math.sqrt(dim_model)
        super().__init__(ref, stop_step)
        self.ref_lr = ref
        self._den_in_warmup = 1.0 / math.sqrt(warmup_step) / warmup_step
        self.update_lr_step(1)

    def update_lr_step(self, n_step):
        n_step = max(n_step, 1)
        self.lr = self.ref_lr * min(1.0 / math.sqrt(n_step),
                                    n_step * self._den_in_warmup)


_REGISTRY = {"SchedulerNoam": SchedulerNoam}


def build_scheduler(cfg: dict, params):
    """cfg = {"type": ..., "kwargs": {...}, "optimizer": {...}}, as the
    JAX package reads it. Returns (scheduler, optimizer over `params`)."""
    if cfg["type"] not in _REGISTRY:
        raise NotImplementedError(f"scheduler {cfg['type']!r} is not ported "
                                  "yet; see ROADMAP.md")
    opt, lr = build_optimizer(cfg["optimizer"], params)
    kwargs = dict(cfg.get("kwargs", {}))
    kwargs.setdefault("lr_init", lr)
    return _REGISTRY[cfg["type"]](**kwargs), opt
