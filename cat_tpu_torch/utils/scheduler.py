"""LR schedulers and optimizer building (counterpart of
`cat_tpu/utils/scheduler.py`).

A scheduler is a host-side state machine that owns a scalar `lr`; the
train step receives it each step, as in the JAX package. `step(metric)`
takes a dev metric (lower is better unless `reverse`) and returns a
`State`: IMPROVED, CONTINUE or TERMINATED, which ends the `Manager`'s
run. `state_dict` is the whole `__dict__`, as in the JAX package, so a
checkpoint restores every counter and flag. All eight registered
schedulers of the JAX package are ported, with the same arithmetic in the
same order, so their lr sequences are equal float for float.

`torch.optim.Adam(betas, eps=1e-8)` makes the update of optax's `adam`:
bias-corrected moments m^ = m / (1 - b1^t), v^ = v / (1 - b2^t) and the
step lr * m^ / (sqrt(v^) + eps), eps outside the root. `AdamW` decays
the weights as optax's `adamw` does, p -= lr * (update + wd * p), with
optax's default wd = 1e-4. The other optimizers of the JAX package are
not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import math
from enum import Enum

import torch


class State(Enum):
    IMPROVED = 0
    CONTINUE = 1
    TERMINATED = 2


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
    """Base: tracks the best metric (lower is better unless `reverse`) and
    the current lr."""

    def __init__(self, lr_init: float, reverse: bool = False):
        self.lr = float(lr_init)
        self.init_lr = float(lr_init)
        self._reverse = reverse
        self.best_metric = float("-inf") if reverse else float("inf")

    def _is_improved(self, metric):
        return self._reverse ^ (metric < self.best_metric)

    def update_lr_step(self, n_step: int):
        return None

    def step(self, metric: float) -> State:
        if self._is_improved(metric):
            self.best_metric = metric
            return State.IMPROVED
        return State.CONTINUE

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, d):
        self.__dict__.update(d)


class SchedulerEarlyStop(Scheduler):
    """Tolerate n_tol worse evals, then lr *= gamma; TERMINATED once the
    next lr would cross stop_lr. Before min_step a worse eval counts for
    nothing."""

    def __init__(self, lr_init, min_step=0, stop_lr=1e-5, n_tol=1,
                 gamma=0.1, reverse=False):
        super().__init__(lr_init, reverse)
        self.stop_lr = stop_lr
        self.min_step = min_step
        self._in_min_step = True
        self.n_tol = n_tol
        self._cnt_worse = 0
        self.gamma = gamma

    def _check_hit_stop(self, new_lr):
        return (self.stop_lr <= new_lr) ^ (self.gamma < 1.0)

    def update_lr_step(self, n_step):
        if self._in_min_step and n_step >= self.min_step:
            self._in_min_step = False

    def step(self, metric):
        if self._is_improved(metric):
            self.best_metric = metric
            return State.IMPROVED
        if self._in_min_step:
            return State.CONTINUE
        self._cnt_worse += 1
        if self._cnt_worse > self.n_tol:
            if self._check_hit_stop(self.lr * self.gamma):
                return State.TERMINATED
            self.lr *= self.gamma
            self._cnt_worse = 0
        return State.CONTINUE


class SchedulerFixedStop(Scheduler):
    """Run exactly stop_step steps: the first eval at or after it
    returns TERMINATED."""

    def __init__(self, lr_init, stop_step, reverse=False):
        super().__init__(lr_init, reverse)
        self.stop_step = int(stop_step)
        self._in_stop_step = True

    def update_lr_step(self, n_step):
        if self._in_stop_step and n_step >= self.stop_step:
            self._in_stop_step = False

    def step(self, metric):
        if self._in_stop_step:
            return super().step(metric)
        return State.TERMINATED


class SchedulerEarlyStopWithWarmup(SchedulerEarlyStop):
    """Linear warmup to max_lr over warmup_step, then early stop."""

    def __init__(self, lr_init, warmup_step, max_lr=None, min_step=None,
                 stop_lr=1e-5, n_tol=1, gamma=0.1, reverse=False):
        if max_lr is None:
            max_lr = lr_init
        if min_step is None:
            min_step = warmup_step
        start_lr = max_lr / max(warmup_step, 1)
        super().__init__(start_lr, min_step, stop_lr, n_tol, gamma, reverse)
        self.lr_addon = (max_lr - start_lr) / max(warmup_step, 1)

    def update_lr_step(self, n_step):
        if self._in_min_step:
            self.lr = self.lr + self.lr_addon
            if n_step >= self.min_step:
                self._in_min_step = False


class SchedulerNoam(SchedulerFixedStop):
    """lr = peak_factor / sqrt(dim_model) * min(1/sqrt(n), n/warmup^1.5),
    TERMINATED at the first eval from stop_step on."""

    def __init__(self, lr_init=None, dim_model=512, warmup_step=4000,
                 stop_step=100000, peak_factor=1.0, reverse=False):
        ref = peak_factor / math.sqrt(dim_model)
        super().__init__(ref, stop_step, reverse)
        self.ref_lr = ref
        self._den_in_warmup = 1.0 / math.sqrt(warmup_step) / warmup_step
        self.update_lr_step(1)

    def update_lr_step(self, n_step):
        super().update_lr_step(n_step)
        n_step = max(n_step, 1)
        self.lr = self.ref_lr * min(1.0 / math.sqrt(n_step),
                                    n_step * self._den_in_warmup)


class SchedulerNoamEarlyStop(SchedulerEarlyStop):
    """The Noam curve, with the early stop's decay folded into its
    reference lr."""

    def __init__(self, lr_init=None, dim_model=512, warmup_step=4000,
                 peak_factor=1.0, stop_lr=1e-5, n_tol=0, gamma=0.1,
                 min_step=-1, reverse=False):
        if min_step == -1:
            min_step = warmup_step
        ref = peak_factor / math.sqrt(dim_model)
        super().__init__(ref, min_step, stop_lr, n_tol, gamma, reverse)
        self.ref_lr = ref
        self._den_in_warmup = 1.0 / math.sqrt(warmup_step) / warmup_step
        self.update_lr_step(1)

    def update_lr_step(self, n_step):
        SchedulerEarlyStop.update_lr_step(self, n_step)
        n_step = max(n_step, 1)
        self.lr = self.ref_lr * min(1.0 / math.sqrt(n_step),
                                    n_step * self._den_in_warmup)

    def step(self, metric):
        prev_lr = self.lr
        state = super().step(metric)
        if prev_lr > 0:
            self.ref_lr *= self.lr / prev_lr
        return state


class SchedulerLinearAnnealing(SchedulerFixedStop):
    """Linear decay from lr_init to stop_lr between min_step and
    stop_step."""

    def __init__(self, lr_init, min_step, stop_lr, stop_step,
                 reverse=False):
        super().__init__(lr_init, stop_step, reverse)
        self.min_step = min_step
        self._in_min_step = True
        self._lr_addon = -(lr_init - stop_lr) / (stop_step - min_step)

    def update_lr_step(self, n_step):
        if self._in_min_step:
            if n_step >= self.min_step:
                self._in_min_step = False
        elif self._in_stop_step:
            self.lr = self.lr + self._lr_addon
            if n_step >= self.stop_step:
                self._in_stop_step = False


class SchedulerCosineAnnealing(SchedulerFixedStop):
    """(Periodic) cosine annealing from lr_init to min_lr, the peak decayed
    by decay_factor each period."""

    def __init__(self, lr_init, min_lr, stop_step, period=0,
                 decay_factor=1.0, reverse=False):
        super().__init__(lr_init, stop_step, reverse)
        if period == 0:
            period = stop_step
        self.period = period
        self.decay_factor = decay_factor
        self.min_lr = min_lr
        self._ref_lr = lr_init

    def update_lr_step(self, n_step):
        super().update_lr_step(n_step)
        max_lr = self._ref_lr * self.decay_factor ** (
            (n_step - 1) // self.period)
        self.lr = (self.min_lr + 0.5 * (max_lr - self.min_lr)
                   * (1 + math.cos(((n_step - 1) % self.period)
                                   / self.period * math.pi)))


_REGISTRY = {cls.__name__: cls for cls in (
    Scheduler, SchedulerEarlyStop, SchedulerFixedStop,
    SchedulerEarlyStopWithWarmup, SchedulerNoam, SchedulerNoamEarlyStop,
    SchedulerLinearAnnealing, SchedulerCosineAnnealing)}


def build_scheduler(cfg: dict, params):
    """cfg = {"type": ..., "kwargs": {...}, "optimizer": {...}}, as the
    JAX package reads it. Returns (scheduler, optimizer over `params`)."""
    if cfg["type"] not in _REGISTRY:
        raise ValueError(f"unknown scheduler {cfg['type']}")
    opt, lr = build_optimizer(cfg["optimizer"], params)
    kwargs = dict(cfg.get("kwargs", {}))
    kwargs.setdefault("lr_init", lr)
    return _REGISTRY[cfg["type"]](**kwargs), opt
