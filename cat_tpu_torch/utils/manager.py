"""The training loop (counterpart of `TrainState`, `MetricLogger` and
`Manager` in `cat_tpu/utils/manager.py`).

`Manager.run` trains epoch by epoch: each batch of the loader goes
through `batch_transform` (default: the `Batch`'s dict of numpy arrays)
and `put_batch` (default: tensors on the model's device) into the train
step, with the scheduler's lr and the Manager's `torch.Generator`. Every
`check_freq` steps (or at each epoch's end when it is <= 0) the dev set
is evaluated, the scheduler steps on the dev loss (or on `eval_metric`),
and a checkpoint is written; a TERMINATED scheduler ends the run. Under
`grad_accum_fold` N each call of the step is a micro-step and the
scheduler advances once per optimizer update: `update_lr_step(ceil(
global_step / N))`. The fold accumulator lives in `TrainState`, so a
checkpoint taken mid-fold carries it. `resume` replays the interrupted
epoch from its start and skips the batches already taken, as the JAX
package does; the loader's epoch order is a function of (seed, epoch).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from cat_tpu_torch.utils.checkpoint import (CheckpointManager,
                                            is_port_checkpoint,
                                            load_checkpoint, model_weights)
from cat_tpu_torch.utils.scheduler import Scheduler, State


@dataclass
class TrainState:
    """The model (parameters and running statistics), its optimizer (with
    the Adam moments), the number of steps taken and of steps skipped by
    the NaN/Inf guard, and the fold accumulator of `grad_accum_fold`: the
    f32 gradient sums, one per trainable parameter in the model's order
    (None until the first micro-step), their total weight and the
    micro-steps taken in the current fold."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    skipped: int = 0
    fold_sums: Optional[list] = None
    fold_weight: Optional[torch.Tensor] = None
    fold_count: int = 0

    def trainable(self):
        return [(n, p) for n, p in self.model.named_parameters()
                if p.requires_grad]

    def state_dict(self):
        fold = None
        if self.fold_sums is not None:
            names = [n for n, _ in self.trainable()]
            fold = {"sums": dict(zip(names, self.fold_sums)),
                    "weight": self.fold_weight, "count": self.fold_count}
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "skipped": self.skipped, "fold": fold}

    def load_state_dict(self, d):
        self.model.load_state_dict(d["model"])
        self.optimizer.load_state_dict(d["optimizer"])
        self.step, self.skipped = int(d["step"]), int(d["skipped"])
        fold = d["fold"]
        if fold is None:
            self.fold_sums, self.fold_weight, self.fold_count = None, None, 0
            return
        self.fold_sums = [fold["sums"][n].to(p.device, copy=True)
                          for n, p in self.trainable()]
        device = self.fold_sums[0].device if self.fold_sums else None
        self.fold_weight = fold["weight"].to(device, copy=True)
        self.fold_count = int(fold["count"])


class MetricLogger:
    """Appends one JSON object a line to `<log_dir>/metrics.jsonl` (the
    JAX package's keys, plus "time") and prints it unless `quiet`."""

    def __init__(self, log_dir, quiet=False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self.quiet = quiet

    def log(self, **kv):
        kv["time"] = time.time()
        with open(self.path, "a") as f:
            f.write(json.dumps(
                kv, default=lambda o: o.item()
                if hasattr(o, "item") else str(o)) + "\n")
        if not self.quiet:
            print(" | ".join(f"{k}={v:.5g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in kv.items()
                             if k != "time"), flush=True)


class Manager:
    """Drives training with the port's step functions.

    Args:
      train_step: fn(state, batch, lr, gen) -> (state, metrics), metrics
        with "loss" (`ctc.train.make_train_step`, `rnnt.train.
        make_train_step`).
      eval_step: fn(state, batch) -> {"loss_sum", "count"}.
      state: the initial `TrainState`.
      scheduler: a `utils.scheduler.Scheduler`.
      ckpt: a `CheckpointManager`.
      train_loader, eval_loader: iterables of `Batch`; train_loader has
        `.epoch(i)`.
      gen: the CPU `torch.Generator` every train step draws from
        (SpecAugment masks, dropout seeds); default seeded with 0. Like the
        JAX package's rng it is not checkpointed: a resumed run draws anew
        from the generator it is given.
      put_batch: fn(dict of arrays) -> the step's batch; default: tensors
        on the model's device, integer arrays as int64.
      batch_transform: fn(Batch) -> dict; default `Batch.asdict`.
      check_freq: steps between evaluations; <= 0: one per epoch.
      grad_accum_fold: micro-steps per optimizer update (the step's own
        fold); the scheduler advances once per update.
      eval_metric: fn(state) -> float (lower is better), the scheduler's
        metric in place of the dev loss.
      profile_steps: (start, stop) global steps between which
        torch.profiler records; its trace goes to `<ckpt>/profile`.
    """

    def __init__(self, train_step, eval_step, state: TrainState,
                 scheduler: Scheduler, ckpt: CheckpointManager, train_loader,
                 eval_loader, logger: Optional[MetricLogger] = None,
                 gen: Optional[torch.Generator] = None,
                 put_batch: Optional[Callable] = None,
                 max_epochs: int = 10000, check_freq: int = -1,
                 verbose: bool = True, profile_steps: Optional[tuple] = None,
                 grad_accum_fold: int = 1,
                 eval_metric: Optional[Callable] = None,
                 batch_transform: Optional[Callable] = None):
        self.train_step = train_step
        self.eval_step = eval_step
        self.state = state
        self.scheduler = scheduler
        self.ckpt = ckpt
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.logger = logger or MetricLogger(ckpt.dir, quiet=not verbose)
        self.gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.put_batch = put_batch or self.to_device
        self.batch_transform = batch_transform or (lambda b: b.asdict())
        self.max_epochs = max_epochs
        self.check_freq = check_freq
        self.grad_accum_fold = max(int(grad_accum_fold), 1)
        self.eval_metric = eval_metric
        self.profile_steps = profile_steps
        self._profiler = None
        self.epoch = 0
        self.global_step = 0
        self._steps_into_epoch = 0
        self._resume_skip_steps = 0

    def to_device(self, batch: dict):
        """The default `put_batch`: every array a tensor on the model's
        device, integer arrays as int64."""
        device = next(self.state.model.parameters()).device
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if not t.is_floating_point():
                t = t.long()
            out[k] = t.to(device)
        return out

    # ------------- persistence -------------

    def save(self, metric):
        return self.ckpt.save({
            "state": self.state.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "epoch": self.epoch,
            "step": self.global_step,
            "steps_into_epoch": self._steps_into_epoch,
        }, metric, self.global_step, self.epoch)

    def resume(self, path):
        """Restore the train state, the scheduler and the counters of a
        checkpoint of the port. A checkpoint taken mid-epoch makes `run`
        replay that epoch, skipping the batches already taken."""
        if not is_port_checkpoint(path):
            raise ValueError(f"{path}: resume takes checkpoints of the port; "
                             "start from a JAX checkpoint with "
                             "load_init_model")
        ck = load_checkpoint(path)
        self.state.load_state_dict(ck["state"])
        self.scheduler.load_state_dict(ck["scheduler"])
        self.global_step = int(ck["step"])
        steps_in = int(ck["steps_into_epoch"])
        if steps_in > 0:
            self.epoch = int(ck["epoch"]) - 1
            self._resume_skip_steps = steps_in
        else:
            self.epoch = int(ck["epoch"])
            self._resume_skip_steps = 0

    def load_init_model(self, path):
        """Weights only (no optimizer, scheduler or counters), as the JAX
        package's --init-model: the model's parameters from a checkpoint of
        the port, or from one of the JAX package through
        `utils/from_jax.py`. Running statistics stay as they are."""
        sd = model_weights(self.state.model, path)
        names = {n for n, _ in self.state.model.named_parameters()}
        missing = names - set(sd)
        if missing:
            raise KeyError(f"{path}: no {sorted(missing)[:3]}...")
        self.state.model.load_state_dict(
            {k: v for k, v in sd.items() if k in names}, strict=False)

    # ------------- loops -------------

    def evaluate(self):
        total, count = 0.0, 0.0
        for batch in self.eval_loader:
            m = self.eval_step(self.state,
                               self.put_batch(self.batch_transform(batch)))
            total += float(m["loss_sum"])
            count += float(m["count"])
        return total / max(count, 1.0)

    def run(self):
        """Train until the scheduler terminates or max_epochs; returns the
        scheduler's best metric."""
        terminated = False
        skip, self._resume_skip_steps = self._resume_skip_steps, 0
        try:
            while not terminated and self.epoch < self.max_epochs:
                self.epoch += 1
                self._steps_into_epoch = skip
                t_data, t_step = 0.0, 0.0
                t0 = time.time()
                for batch in self.train_loader.epoch(self.epoch):
                    if skip > 0:
                        skip -= 1
                        t0 = time.time()
                        continue
                    t_data += time.time() - t0
                    self.global_step += 1
                    self._profile()
                    self._steps_into_epoch += 1
                    self.scheduler.update_lr_step(
                        -(-self.global_step // self.grad_accum_fold))
                    t1 = time.time()
                    self.state, metrics = self.train_step(
                        self.state,
                        self.put_batch(self.batch_transform(batch)),
                        self.scheduler.lr, self.gen)
                    t_step += time.time() - t1
                    if self.check_freq > 0 and \
                            self.global_step % self.check_freq == 0:
                        terminated = self._checkpoint_round(metrics)
                        if terminated:
                            break
                    t0 = time.time()
                self._steps_into_epoch = 0  # the epoch is complete
                if not terminated and self.check_freq <= 0:
                    terminated = self._checkpoint_round(None)
                self.logger.log(epoch=self.epoch, data_s=t_data,
                                step_s=t_step)
        finally:
            self._stop_profile()
        return self.scheduler.best_metric

    def _profile(self):
        if self.profile_steps is None:
            return
        start, stop = self.profile_steps
        if self.global_step == start and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if next(self.state.model.parameters()).is_cuda:
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()
        elif self.global_step == stop:
            self._stop_profile()

    def _stop_profile(self):
        """Stop torch.profiler, if it runs, and write its chrome trace to
        `<ckpt>/profile/trace_<start>-<step>.json`."""
        if self._profiler is None:
            return
        prof, self._profiler = self._profiler, None
        prof.stop()
        out = os.path.join(self.ckpt.dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            out, f"trace_{self.profile_steps[0]}-{self.global_step}.json"))

    def _checkpoint_round(self, last_train_metrics):
        dev_loss = self.evaluate()
        metric = dev_loss
        kv = dict(step=self.global_step, epoch=self.epoch,
                  dev_loss=dev_loss)
        if self.eval_metric is not None:
            metric = float(self.eval_metric(self.state))
            kv["dev_metric"] = metric
        st = self.scheduler.step(metric)
        kv.update(lr=self.scheduler.lr, sched=st.name)
        if last_train_metrics is not None:
            kv["train_loss"] = float(last_train_metrics.get("loss", 0.0))
        self.logger.log(**kv)
        self.save(metric)
        return st == State.TERMINATED
