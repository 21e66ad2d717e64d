"""CTC / CTC-CRF model assembly and train step (counterpart of
`cat_tpu/ctc/train.py`).

`make_train_step` returns one step: SpecAugment -> encoder (training
mode: dropout, batch statistics) -> log-softmax -> loss -> backward ->
global grad-norm clipping -> Adam update, with the NaN/Inf guard: on a
non-finite loss or gradient norm, the parameters, the optimizer state and
the running statistics stay as they were and `skipped` is 1. Every random
draw of a step (SpecAugment masks, dropout seeds) comes from the
`torch.Generator` the caller passes. On the card every fused op of the
encoder, the standalone dropout and the loss recursions (CTC alpha and
beta, the dense denominator forward and backward) run their CUDA kernels.
With `grad_accum_fold` N > 1 a step is one micro-step of a weighted
fold-N accumulation (`utils/grad_accum.py`): the optimizer steps on every
N-th call, and the accumulator lives in the `TrainState`.
"""
from __future__ import annotations

from typing import Optional

import torch

from cat_tpu_torch import models
from cat_tpu_torch.ops.crf_dense import DenseDen, ctc_crf_loss_dense
from cat_tpu_torch.ops.ctc import ctc_loss
from cat_tpu_torch.ops.specaug import specaug
from cat_tpu_torch.utils.grad_accum import WeightedMultiSteps
from cat_tpu_torch.utils.manager import TrainState
from cat_tpu_torch.utils.scheduler import set_lr


def build_model(cfg: dict, num_classes: int, device=None, seed: int = 0):
    """cfg: {"encoder": {"type": ..., "kwargs": {...}}}; the vocabulary size
    is injected. Weights are random, drawn from a generator seeded with
    `seed` (a checkpoint replaces them). Returns the model in eval mode on
    `device`, which defaults to "cuda" and raises when CUDA is missing:
    pass device="cpu" for the plain PyTorch path. `.train()` is the
    caller's choice."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    enc_cfg = cfg["encoder"]
    kwargs = dict(enc_cfg.get("kwargs", {}))
    kwargs["num_classes"] = num_classes
    cls = models.get_encoder(enc_cfg["type"])
    model = cls(**kwargs, generator=torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def init_state(model, optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer)


def _weighted_mean(per_seq, weight):
    return (per_seq * weight).sum() / torch.clamp_min(weight.sum(), 1.0)


def make_loss_fn(model, loss_type="ctc", den: Optional[DenseDen] = None,
                 lamb: float = 0.1, specaug_cfg: Optional[dict] = None):
    """Returns loss_fn(batch, gen, train) -> (weighted mean loss, per-
    sequence loss). batch: "feats" (N, T, F), "feat_lengths", "labels"
    (N, U), "label_lengths", "weight" (N,), all on the model's device.
    The caller sets the model's mode."""
    if loss_type == "crf" and not isinstance(den, DenseDen):
        raise NotImplementedError("the port's CTC-CRF loss takes the dense "
                                  "denominator (DenseDen); the arc-table "
                                  "one is not ported yet, see ROADMAP.md")

    def loss_fn(batch, gen, train):
        feats = batch["feats"]
        flens = batch["feat_lengths"]
        if train and specaug_cfg is not None:
            feats = specaug(gen, feats, flens, **specaug_cfg)
        logits, out_lens = model(feats, flens, gen if train else None)
        lp = torch.log_softmax(logits.float(), dim=-1)
        labels, llens = batch["labels"], batch["label_lengths"]
        if loss_type == "ctc":
            per_seq = ctc_loss(lp, labels, out_lens, llens, reduction="none")
        elif loss_type == "crf":
            per_seq = ctc_crf_loss_dense(lp, labels, out_lens, llens, den,
                                         lamb, reduction="none")
        else:
            raise ValueError(loss_type)
        return _weighted_mean(per_seq, batch["weight"].float()), per_seq

    return loss_fn


def global_grad_norm(params):
    """sqrt of the sum of squares of every gradient (None counts as 0)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad.float()) for p in params
         if p.grad is not None]))


def make_train_step(model, optimizer, loss_type="ctc", den=None, lamb=0.1,
                    specaug_cfg=None, grad_clip=5.0, grad_accum_fold=1):
    """Returns train_step(state, batch, lr, gen) -> (state, metrics):
    metrics "loss", "grad_norm" (tensors) and "skipped" (0 or 1), and with
    grad_accum_fold > 1 "applied" (0 or 1). The step updates
    `state.model` and `state.optimizer` in place."""
    return make_step(model, optimizer,
                     make_loss_fn(model, loss_type, den, lamb, specaug_cfg),
                     grad_clip, grad_accum_fold)


def make_step(model, optimizer, loss_fn, grad_clip=5.0, grad_accum_fold=1):
    """`make_train_step` around any loss_fn(batch, gen, train) ->
    (weighted mean loss, per-sequence loss): backward, the NaN/Inf guard,
    clipping and the optimizer step, or one micro-step of the weighted
    fold when grad_accum_fold > 1. The RNN-T trainer shares it."""
    params = [p for p in model.parameters() if p.requires_grad]
    if grad_accum_fold > 1:
        return _make_accum_train_step(model, loss_fn, WeightedMultiSteps(
            optimizer, params, grad_accum_fold, grad_clip))

    def train_step(state: TrainState, batch, lr, gen):
        stats = [b.detach().clone() for b in model.buffers()]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(batch, gen, True)
        loss.backward()
        gnorm = global_grad_norm(params)
        finite = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        if finite:
            if grad_clip > 0:
                scale = torch.clamp_max(grad_clip / (gnorm + 1e-6), 1.0)
                for p in params:
                    if p.grad is not None:
                        p.grad.mul_(scale)
            set_lr(optimizer, lr)
            optimizer.step()
        else:
            # the guard: a poisoned batch leaves every state untouched
            _restore(model, stats)
            optimizer.zero_grad(set_to_none=True)
        state.step += 1
        state.skipped += int(not finite)
        return state, {"loss": loss.detach(), "grad_norm": gnorm,
                       "skipped": int(not finite)}

    return train_step


def _restore(model, stats):
    with torch.no_grad():
        for b, old in zip(model.buffers(), stats):
            b.copy_(old)


def _make_accum_train_step(model, loss_fn, fold: WeightedMultiSteps):
    """One micro-step of the weighted fold (`_make_accum_train_step` of the
    JAX package): the gradient of the weighted SUM of per-sequence losses
    and the micro-batch's weight go to `fold`, which steps the optimizer
    at the fold's end. The NaN/Inf guard works per micro-batch: a poisoned
    one adds nothing (weight 0) and keeps the old running statistics, and
    still counts as a micro-step of the fold. Metrics: "loss" (the
    weighted sum over the micro-batch's weight), "grad_norm" (of the
    fold's mean gradient so far), "applied", "skipped"."""

    def train_step(state: TrainState, batch, lr, gen):
        stats = [b.detach().clone() for b in model.buffers()]
        model.train()
        fold.optimizer.zero_grad(set_to_none=True)
        _, per_seq = loss_fn(batch, gen, True)
        w = batch["weight"].float()
        loss_sum = (per_seq * w).sum()
        loss_sum.backward()
        micro = global_grad_norm(fold.params)
        finite = bool(torch.isfinite(loss_sum) & torch.isfinite(micro))
        w_sum = w.sum()
        if not finite:
            _restore(model, stats)
            fold.optimizer.zero_grad(set_to_none=True)
            w_sum = torch.zeros_like(w_sum)
            loss_sum = torch.zeros_like(loss_sum)
        gnorm, applied = fold.update(state, w_sum, lr)
        state.step += 1
        state.skipped += int(not finite)
        return state, {"loss": loss_sum.detach() / torch.clamp_min(w_sum, 1.0),
                       "grad_norm": gnorm, "applied": int(applied),
                       "skipped": int(not finite)}

    return train_step


def make_eval_step(model, loss_type="ctc", den=None, lamb=0.1):
    """Returns eval_step(state, batch) -> {"loss_sum", "count"}."""
    loss_fn = make_loss_fn(model, loss_type, den, lamb, None)

    def eval_step(state: TrainState, batch):
        model.eval()
        with torch.no_grad():
            _, per_seq = loss_fn(batch, None, False)
        w = batch["weight"].float()
        return {"loss_sum": (per_seq * w).sum(), "count": w.sum()}

    return eval_step
