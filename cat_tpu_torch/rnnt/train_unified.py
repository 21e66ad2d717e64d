"""CUSIDE unified (streaming + full-context) RNN-T trainer (counterpart of
`cat_tpu/rnnt/train_unified.py`), with the signatures of
`cat_tpu_torch.rnnt.train` so that a recipe's bin
`cat_tpu.rnnt.train_unified` trains through the pipeline.

`UnifiedTransducerModel` is a `ctc.streaming.UnifiedEncoder` (the
config's encoder without its classifier, and a SimuNet) under the
predictor and joiner of `rnnt.train`. A step's loss is (1 − λ)·NLL(full)
+ λ·NLL(chunk) + λ_simu·L1, each NLL `rnnt.train.transducer_nll` (the
fused simple loss for a LogAdd joiner, `rnnt_loss` or, for topo
"rna"/"ctct", `rnnt_loss_rna`) as a weighted mean. SpecAugment is drawn
once in the loss and feeds both passes and the simulator's L1; the
predictor runs once a pass. The running statistics after a step are the
chunk pass's (`ctc.streaming.two_passes`). The step is
`ctc.train.make_step`'s: the NaN/Inf guard, clipping, Adam and
`grad_accum_fold` (the joint loss broadcast as the per-sequence loss).
Decoding: `encode` is the full pass, `encode_streaming` the chunk pass.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cat_tpu_torch import models
from cat_tpu_torch.ctc.streaming import build_unified, two_passes
from cat_tpu_torch.ctc.train import (_weighted_mean, init_state,  # noqa
                                     make_step)
from cat_tpu_torch.ops.specaug import specaug
from cat_tpu_torch.rnnt.train import (TOPOS, TransducerModel, _append_eos,
                                      transducer_nll)


class UnifiedTransducerModel(nn.Module):
    """Unified encoder (full and chunked) + predictor + joiner."""

    def __init__(self, uenc, predictor, joiner, predictor_mask_range=0.1,
                 num_predictor_mask=-1):
        super().__init__()
        self.uenc = uenc
        self.predictor = predictor
        self.joiner = joiner
        self.predictor_mask_range = predictor_mask_range
        self.num_predictor_mask = num_predictor_mask

    draw_predictor_masks = TransducerModel.draw_predictor_masks
    predict_labels = TransducerModel.predict_labels
    join = TransducerModel.join
    predict_step = TransducerModel.predict_step

    def full_forward(self, feats, flens, labels, llens, gen=None):
        """-> (the joiner's output over the full pass, output lengths)."""
        enc, olens = self.uenc.full_forward(feats, flens, gen)
        return self.joiner(enc, self.predict_labels(labels, llens, gen)), olens

    forward = full_forward

    def chunk_forward(self, feats, flens, labels, llens, gen=None,
                      future="simu"):
        """-> (the joiner's output over the chunk pass, output lengths,
        simu_l1)."""
        enc, olens, simu_l1 = self.uenc.chunk_forward(feats, flens, gen,
                                                      future)
        pred = self.predict_labels(labels, llens, gen)
        return self.joiner(enc, pred), olens, simu_l1

    def encode(self, feats, flens):
        return self.uenc.full_forward(feats, flens)

    def encode_streaming(self, feats, flens, future="simu"):
        enc, olens, _ = self.uenc.chunk_forward(feats, flens, None, future)
        return enc, olens


def build_model(cfg: dict, num_classes: int, device=None, seed: int = 0):
    """cfg: `rnnt.train.build_model`'s blocks plus "unified" (chunk
    geometry and SimuNet, `ctc.streaming.build_unified`). Random weights
    from `seed`; eval mode on `device` ("cuda" by default; "cpu" for the
    plain path)."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    gen = torch.Generator().manual_seed(seed)
    enc_cfg = cfg["encoder"]
    enc_kw = dict(enc_cfg.get("kwargs", {}))
    enc_kw["with_head"] = False
    enc_kw.pop("num_classes", None)
    encoder = models.get_encoder(enc_cfg["type"])(**enc_kw, generator=gen)
    uenc = build_unified(encoder, cfg, gen)

    pred_cfg = cfg.get("predictor", cfg.get("decoder"))
    pred_kw = dict(pred_cfg.get("kwargs", {}))
    pred_kw.setdefault("vocab_size", num_classes)
    pred_kw["with_head"] = False
    predictor = models.get_decoder(pred_cfg["type"])(**pred_kw,
                                                     generator=gen)
    join_cfg = cfg["joiner"]
    join_kw = dict(join_cfg.get("kwargs", {}))
    join_kw.update(odim=num_classes, denc=encoder.odim, dpred=predictor.hdim)
    joiner = models.get_joiner(join_cfg["type"])(**join_kw, generator=gen)
    tr = cfg.get("trainer", {})
    model = UnifiedTransducerModel(
        uenc, predictor, joiner,
        predictor_mask_range=tr.get("predictor_mask_range", 0.1),
        num_predictor_mask=tr.get("num_predictor_mask", -1))
    return model.to(device).eval()


def make_loss_fn(model, specaug_cfg: Optional[dict] = None,
                 joiner_normalized=False, topo="rnnt", eos_id=-1,
                 lamb_chunk=0.5, lamb_simu=1.0, future="simu"):
    """Returns loss_fn(batch, gen, train) -> (joint loss, the joint loss
    broadcast over the batch as its per-sequence loss, {"loss_full",
    "loss_chunk", "loss_simu"}). The caller sets the model's mode."""
    if topo not in TOPOS:
        raise ValueError(f"RNN-T topo {topo!r} is not one of {TOPOS}")

    def loss_fn(batch, gen, train):
        feats, flens = batch["feats"], batch["feat_lengths"]
        if train and specaug_cfg is not None:
            feats = specaug(gen, feats, flens, **specaug_cfg)
        labels, llens = batch["labels"], batch["label_lengths"]
        if eos_id >= 0:
            labels, llens = _append_eos(labels, llens, eos_id)
        g = gen if train else None
        (f_out, f_lens), (c_out, c_lens, simu_l1) = two_passes(
            model, lambda: model.full_forward(feats, flens, labels, llens, g),
            lambda: model.chunk_forward(feats, flens, labels, llens, g,
                                        future), train)
        w = batch["weight"].float()

        def nll(out, lens):
            return _weighted_mean(transducer_nll(
                model, out, labels, lens, llens, joiner_normalized, topo), w)

        loss_full, loss_chunk = nll(f_out, f_lens), nll(c_out, c_lens)
        loss = ((1 - lamb_chunk) * loss_full + lamb_chunk * loss_chunk
                + lamb_simu * simu_l1)
        return loss, loss.expand(w.shape), {
            "loss_full": loss_full, "loss_chunk": loss_chunk,
            "loss_simu": simu_l1}

    return loss_fn


def make_train_step(model, optimizer, specaug_cfg=None, grad_clip=5.0,
                    joiner_normalized=False, topo="rnnt", eos_id=-1,
                    grad_accum_fold=1, lamb_chunk=0.5, lamb_simu=1.0,
                    future="simu"):
    """Returns train_step(state, batch, lr, gen) -> (state, metrics "loss",
    "loss_full", "loss_chunk", "loss_simu", "grad_norm", "skipped"; with
    grad_accum_fold > 1 "applied" and the joint loss alone)."""
    return make_step(model, optimizer,
                     make_loss_fn(model, specaug_cfg, joiner_normalized, topo,
                                  eos_id, lamb_chunk, lamb_simu, future),
                     grad_clip, grad_accum_fold)


def make_eval_step(model, joiner_normalized=False, topo="rnnt", eos_id=-1,
                   lamb_chunk=0.5, future="simu", **_unused):
    """Returns eval_step(state, batch) -> {"loss_sum", "count"}: the joint
    loss at λ_simu = 0 times the batch's weight."""
    loss_fn = make_loss_fn(model, None, joiner_normalized, topo, eos_id,
                           lamb_chunk, 0.0, future)

    def eval_step(state, batch):
        model.eval()
        with torch.no_grad():
            loss = loss_fn(batch, None, False)[0]
        cnt = batch["weight"].float().sum()
        return {"loss_sum": loss * cnt, "count": cnt}

    return eval_step
