"""CUSIDE unified (streaming + full-context) CTC trainer (counterpart of
`cat_tpu/ctc/train_unified.py`), with the signatures of
`cat_tpu_torch.ctc.train` so that a recipe's bin `cat_tpu.ctc.train_unified`
trains through the pipeline.

The model is a `ctc.streaming.UnifiedEncoder` over the config's encoder
(with its classifier) and a SimuNet; a step's loss is
`make_unified_loss_fn`'s. Two quirks of the JAX trainer are kept:
`loss_type`, `den` and `lamb` are accepted and ignored, so a CTC-CRF
config trains plain CTC on both passes (ROADMAP.md caveat C.13); and the
step has no NaN/Inf guard: a non-finite loss updates the weights as any
other (the fold path keeps the shared per-micro-batch guard).
"""
from __future__ import annotations

import torch

from cat_tpu_torch import models
from cat_tpu_torch.ctc.streaming import build_unified, make_unified_loss_fn
from cat_tpu_torch.ctc.train import (_make_accum_train_step, global_grad_norm,
                                     init_state)  # noqa: F401
from cat_tpu_torch.ops.specaug import specaug
from cat_tpu_torch.utils.grad_accum import WeightedMultiSteps
from cat_tpu_torch.utils.scheduler import set_lr


def build_model(cfg: dict, num_classes: int, device=None, seed: int = 0):
    """The `UnifiedEncoder` of cfg's "encoder" (the vocabulary size
    injected) and "unified" blocks, random weights from `seed`, in eval
    mode on `device` ("cuda" by default; pass "cpu" for the plain
    path)."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    gen = torch.Generator().manual_seed(seed)
    enc_cfg = cfg["encoder"]
    kw = dict(enc_cfg.get("kwargs", {}))
    kw["num_classes"] = num_classes
    encoder = models.get_encoder(enc_cfg["type"])(**kw, generator=gen)
    return build_unified(encoder, cfg, gen).to(device).eval()


def make_train_step(model, optimizer, loss_type="ctc", den=None, lamb=0.1,
                    specaug_cfg=None, grad_clip=5.0, lamb_chunk=0.5,
                    lamb_simu=1.0, future="simu", grad_accum_fold=1):
    """Returns train_step(state, batch, lr, gen) -> (state, metrics
    "loss", "loss_full", "loss_chunk", "loss_simu", "grad_norm" and
    "skipped" (always 0 but in the fold path); with grad_accum_fold > 1
    "applied"). SpecAugment is drawn once in the step and feeds both
    passes and the simulator's L1."""
    loss_fn = make_unified_loss_fn(model, lamb_chunk, lamb_simu, future)
    params = [p for p in model.parameters() if p.requires_grad]

    def augmented(batch, gen):
        if specaug_cfg is None:
            return batch
        return dict(batch, feats=specaug(gen, batch["feats"],
                                         batch["feat_lengths"], **specaug_cfg))

    if grad_accum_fold > 1:
        # the joint loss is a weighted mean over the batch: broadcast as
        # the per-sequence loss, the fold's weighted sums stay exact
        def fold_loss(batch, gen, train):
            if train:
                batch = augmented(batch, gen)
            loss, _ = loss_fn(batch, gen, train)
            return loss, loss.expand(batch["weight"].shape)

        return _make_accum_train_step(model, fold_loss, WeightedMultiSteps(
            optimizer, params, grad_accum_fold, grad_clip))

    def train_step(state, batch, lr, gen):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, (lf, lc, l1) = loss_fn(augmented(batch, gen), gen, True)
        loss.backward()
        gnorm = global_grad_norm(params)
        if grad_clip > 0:
            scale = torch.clamp_max(grad_clip / (gnorm + 1e-6), 1.0)
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(scale)
        set_lr(optimizer, lr)
        optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "loss_full": lf.detach(),
                       "loss_chunk": lc.detach(), "loss_simu": l1.detach(),
                       "grad_norm": gnorm, "skipped": 0}

    return train_step


def make_eval_step(model, loss_type="ctc", den=None, lamb=0.1, future="simu"):
    """Returns eval_step(state, batch) -> {"loss_sum", "count"}: the joint
    loss at λ = 0.5, λ_simu = 0, times the batch's weight."""
    loss_fn = make_unified_loss_fn(model, 0.5, 0.0, future)

    def eval_step(state, batch):
        model.eval()
        with torch.no_grad():
            loss, _ = loss_fn(batch, None, False)
        cnt = batch["weight"].float().sum()
        return {"loss_sum": loss * cnt, "count": cnt}

    return eval_step
