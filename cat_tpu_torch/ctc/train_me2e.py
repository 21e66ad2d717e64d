"""Multichannel end-to-end (ME2E) CTC: the beamforming front end and the
acoustic model trained jointly (counterpart of `cat_tpu/ctc/train_me2e.py`).

Batches carry raw multichannel waves: "feats" (N, C, L) float32, or (N,
L, C) with `channels_last` (the packed layout, time-major for
bucketing), and "feat_lengths" in samples. The model is
`front.BeamformerNet` (STFT, (DNN-)WPE, masks, beamformer, log-mel; plain
PyTorch on every device) feeding the config's encoder (on the card the
conformer runs the port's CUDA kernels, and the CTC loss its alpha and
beta kernels).

The step keeps the JAX trainer's NaN/Inf guard, which is not the plain
ASR trainers' (ROADMAP.md caveat C.16): every non-finite gradient element
is zeroed, the clipping scale is 0 when the loss or the gradient norm is
not finite, and the optimizer steps all the same, on zero gradients (so
Adam's moments decay, its count advances and the parameters move by the
decayed momentum); the running statistics of the poisoned pass are kept,
and "skipped" is reported as a float. Every parameter takes part in the
step, one the loss does not reach (DNN-WPE's noise head) with a zero
gradient, as in JAX. The config's "specaug" block and trainer.loss are
ignored, as the JAX trainer ignores them: ME2E trains CTC on unmasked
features (caveat C.17).
"""
from __future__ import annotations

import torch
from torch import nn

from cat_tpu_torch import models
from cat_tpu_torch.ctc.train import _weighted_mean, global_grad_norm
from cat_tpu_torch.front.beamformer import BeamformerNet
from cat_tpu_torch.ops.ctc import ctc_loss
from cat_tpu_torch.utils.data_prep import check_device
from cat_tpu_torch.utils.manager import TrainState
from cat_tpu_torch.utils.scheduler import set_lr


class Me2eModel(nn.Module):
    """frontend (a `BeamformerNet`) -> encoder (with its classifier)."""

    def __init__(self, frontend, encoder):
        super().__init__()
        self.frontend = frontend
        self.encoder = encoder

    def forward(self, wave, wave_lengths, gen=None):
        """wave (N, C, L), wave_lengths (N,) samples -> (logits (N, T', V),
        output lengths); `gen` seeds the encoder's dropout in training
        mode."""
        feats, flens = self.frontend(wave, wave_lengths)
        return self.encoder(feats, flens, gen)

    def features(self, wave, wave_lengths):
        """The front end's (log-mel (N, T, B), frame lengths)."""
        return self.frontend(wave, wave_lengths)


def frontend_kwargs(cfg: dict, kaldi: bool = False) -> dict:
    """The config's frontend kwargs; the kaldi bins turn kaldi_framing on
    by default and read the `noSE` spelling of no_enhance."""
    kw = dict(cfg.get("frontend", {}).get("kwargs", {}))
    if kaldi:
        kw.setdefault("kaldi_framing", True)
        if "noSE" in kw:
            kw["no_enhance"] = bool(kw.pop("noSE"))
    return kw


def build_parts(cfg: dict, num_classes: int, gen, kaldi=False):
    """(BeamformerNet, encoder) of the config, weights drawn from `gen`;
    the encoder's input width is the front end's num_bins."""
    frontend = BeamformerNet(**frontend_kwargs(cfg, kaldi), generator=gen)
    enc_cfg = cfg["encoder"]
    kw = dict(enc_cfg.get("kwargs", {}))
    kw["num_classes"] = num_classes
    kw.setdefault("idim", frontend.num_bins)
    encoder = models.get_encoder(enc_cfg["type"])(**kw, generator=gen)
    return frontend, encoder


def build_model(cfg: dict, num_classes: int, device=None, seed: int = 0,
                kaldi: bool = False) -> Me2eModel:
    """The `Me2eModel` of cfg's "frontend" and "encoder" blocks (the
    vocabulary size injected), random weights from `seed`, in eval mode on
    `device` ("cuda" by default; pass "cpu" for the plain path)."""
    device = check_device(device)
    gen = torch.Generator().manual_seed(seed)
    return Me2eModel(*build_parts(cfg, num_classes, gen, kaldi)).to(
        device).eval()


def init_state(model, optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer)


def batch_wave(batch, channels_last=False):
    """The batch's wave as (N, C, L)."""
    wave = batch["feats"]
    return wave.transpose(1, 2) if channels_last else wave


def make_loss_fn(model, channels_last=False):
    """loss_fn(batch, gen, train) -> (weighted mean CTC loss, per-sequence
    loss); the caller sets the model's mode."""

    def loss_fn(batch, gen, train):
        logits, olens = model(batch_wave(batch, channels_last),
                              batch["feat_lengths"], gen if train else None)
        lp = torch.log_softmax(logits.float(), dim=-1)
        per_seq = ctc_loss(lp, batch["labels"], olens,
                           batch["label_lengths"], reduction="none")
        return _weighted_mean(per_seq, batch["weight"].float()), per_seq

    return loss_fn


def make_guarded_step(model, optimizer, loss_fn, grad_clip=5.0):
    """train_step(state, batch, lr, gen) -> (state, metrics "loss",
    "grad_norm", "skipped" (0.0 or 1.0) and the loss_fn's optional third
    item's terms) with the JAX ME2E trainers' guard (see the module's
    docstring). The step updates `state.model` and `state.optimizer` in
    place."""
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(state: TrainState, batch, lr, gen):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, _, *terms = loss_fn(batch, gen, True)
        loss.backward()
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            gnorm = global_grad_norm(params)
            finite = torch.isfinite(gnorm) & torch.isfinite(loss.detach())
            scale = torch.where(finite, torch.clamp_max(
                grad_clip / (gnorm + 1e-6), 1.0), 0.0)
            for p in params:
                p.grad.copy_(torch.where(torch.isfinite(p.grad),
                                         p.grad * scale, 0.0))
        set_lr(optimizer, lr)
        optimizer.step()
        skipped = 1.0 - float(finite)
        state.step += 1
        state.skipped += int(skipped)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in (terms or [{}])[0].items()}
        return state, {"loss": loss.detach(), "grad_norm": gnorm,
                       "skipped": skipped, **metrics}

    return train_step


def make_train_step(model, optimizer, grad_clip=5.0, specaug_cfg=None,
                    channels_last=False):
    """Returns train_step(state, batch, lr, gen) -> (state, metrics): CTC
    on the model's logits, the guard, clipping at `grad_clip`, the
    optimizer step. `specaug_cfg` is accepted and ignored, as in JAX."""
    return make_guarded_step(model, optimizer,
                             make_loss_fn(model, channels_last), grad_clip)


def make_eval_step(model, channels_last=False):
    """Returns eval_step(state, batch) -> {"loss_sum", "count"}."""
    loss_fn = make_loss_fn(model, channels_last)

    def eval_step(state: TrainState, batch):
        model.eval()
        with torch.no_grad():
            _, per_seq = loss_fn(batch, None, False)
        w = batch["weight"].float()
        return {"loss_sum": (per_seq * w).sum(), "count": w.sum()}

    return eval_step
