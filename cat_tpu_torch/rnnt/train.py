"""RNN-T model assembly and train step (counterpart of
`cat_tpu/rnnt/train.py`).

`TransducerModel` bundles the encoder (a `ConformerNet` or an `LSTM`
without its classifier), the predictor and the joiner; blank = <bos> =
0. The loss is `ops.rnnt.rnnt_loss` on the (N, T, U+1, V) log-prob
lattice, or, for a `LogAdd` joiner, the fused
`ops.rnnt_simple.rnnt_loss_simple`, which never builds it. `make_train_step` wraps the loss in the CTC trainer's step
(`cat_tpu_torch.ctc.train.make_step`: the NaN/Inf guard, clipping, Adam,
`grad_accum_fold`). Every random draw (SpecAugment and predictor masks,
dropout seeds) comes from the `torch.Generator` the caller passes. On the
card the encoder's fused ops, its dropout and the two lattice recursions
run their CUDA kernels. The monotonic topologies ("rna"/"ctct",
`cat_tpu/ops/rnnt_rna.py`) are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cat_tpu_torch import models
from cat_tpu_torch.ctc.train import init_state, make_step  # noqa: F401
from cat_tpu_torch.models.joiner import LogAdd
from cat_tpu_torch.ops.rnnt import rnnt_loss
from cat_tpu_torch.ops.rnnt_simple import rnnt_loss_simple
from cat_tpu_torch.ops.specaug import draw_time_masks, mask_time, specaug


class TransducerModel(nn.Module):
    """Encoder + predictor + joiner. In training mode with
    num_predictor_mask > 0 the predictor output gets SpecAugment-style
    time masks whose width is capped at predictor_mask_range (a fraction
    of the label length when < 1, an absolute width otherwise)."""

    def __init__(self, encoder, predictor, joiner, predictor_mask_range=0.1,
                 num_predictor_mask=-1):
        super().__init__()
        self.encoder = encoder
        self.predictor = predictor
        self.joiner = joiner
        self.predictor_mask_range = predictor_mask_range
        self.num_predictor_mask = num_predictor_mask

    def draw_predictor_masks(self, gen, lengths, U1):
        """(starts, widths) of the predictor's time masks, from `gen`."""
        if self.predictor_mask_range < 1:
            cap, ratio = U1, self.predictor_mask_range
        else:
            cap, ratio = int(self.predictor_mask_range), 1.0
        return draw_time_masks(gen, lengths, self.num_predictor_mask, cap,
                               ratio)

    def forward(self, feats, flens, labels, llens, gen=None):
        """-> (logits (N, T', U+1, V) f32, or (f, g) for a LogAdd joiner,
        output lengths)."""
        enc, olens = self.encoder(feats, flens, gen)
        pred_in = F.pad(labels.long(), (1, 0))
        pred, _ = self.predictor(pred_in, llens + 1, gen)
        if self.training and self.num_predictor_mask > 0:
            pred = mask_time(pred, *self.draw_predictor_masks(
                gen, llens + 1, pred.shape[1]))
        return self.joiner(enc, pred), olens

    def encode(self, feats, flens):
        return self.encoder(feats, flens)

    def join(self, enc, pred):
        return self.joiner(enc, pred)

    def predict_step(self, tokens, state):
        """Incremental predictor step for decoding."""
        return self.predictor.step(tokens, state)


def build_model(cfg: dict, num_classes: int, device=None, seed: int = 0):
    """cfg: {"encoder", "predictor" (or "decoder"), "joiner": {"type",
    "kwargs"}, "trainer"}; the vocabulary size is injected. Weights are
    random, drawn from a generator seeded with `seed` (a checkpoint
    replaces them). Returns the model in eval mode on `device`, which
    defaults to "cuda" and raises when CUDA is missing: pass device="cpu"
    for the plain PyTorch path."""
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
    model = TransducerModel(
        encoder, predictor, joiner,
        predictor_mask_range=tr.get("predictor_mask_range", 0.1),
        num_predictor_mask=tr.get("num_predictor_mask", -1))
    return model.to(device).eval()


def _append_eos(labels, llens, eos_id: int):
    """Append <eos> after the last label: one more column, eos at
    position llens."""
    labels = F.pad(labels.long(), (0, 1))
    pos = torch.arange(labels.shape[1], device=labels.device)[None, :]
    return torch.where(pos == llens[:, None], eos_id, labels), llens + 1


def make_loss_fn(model, specaug_cfg: Optional[dict] = None,
                 joiner_normalized: bool = False, topo: str = "rnnt",
                 eos_id: int = -1):
    """Returns loss_fn(batch, gen, train) -> (weighted mean loss, per-
    sequence loss). joiner_normalized: the joiner gives log-probs (HAT).
    eos_id >= 0 appends <eos> to the targets. A LogAdd joiner goes to the
    fused simple loss. The caller sets the model's mode."""
    if topo != "rnnt":
        raise NotImplementedError(f"RNN-T topo {topo!r} (ops/rnnt_rna.py) is "
                                  "not ported to cat_tpu_torch yet; see "
                                  "ROADMAP.md")
    is_simple = isinstance(model.joiner, LogAdd)

    def loss_fn(batch, gen, train):
        feats = batch["feats"]
        flens = batch["feat_lengths"]
        if train and specaug_cfg is not None:
            feats = specaug(gen, feats, flens, **specaug_cfg)
        labels, llens = batch["labels"], batch["label_lengths"]
        if eos_id >= 0:
            labels, llens = _append_eos(labels, llens, eos_id)
        out, olens = model(feats, flens, labels, llens,
                           gen if train else None)
        if is_simple:
            per_seq = rnnt_loss_simple(out[0].float(), out[1].float(),
                                       labels, olens, llens,
                                       reduction="none")
        else:
            lp = out.float()
            if not joiner_normalized:
                lp = torch.log_softmax(lp, dim=-1)
            per_seq = rnnt_loss(lp, labels, olens, llens, reduction="none")
        w = batch["weight"].float()
        return (per_seq * w).sum() / torch.clamp_min(w.sum(), 1.0), per_seq

    return loss_fn


def make_train_step(model, optimizer, specaug_cfg=None, grad_clip=5.0,
                    joiner_normalized=False, topo="rnnt", eos_id=-1,
                    grad_accum_fold=1):
    """Returns train_step(state, batch, lr, gen) -> (state, metrics), as
    `cat_tpu_torch.ctc.train.make_train_step` does."""
    return make_step(model, optimizer,
                     make_loss_fn(model, specaug_cfg, joiner_normalized,
                                  topo, eos_id),
                     grad_clip, grad_accum_fold)


def make_eval_step(model, joiner_normalized=False, topo="rnnt", eos_id=-1):
    """Returns eval_step(state, batch) -> {"loss_sum", "count"}."""
    loss_fn = make_loss_fn(model, None, joiner_normalized, topo, eos_id)

    def eval_step(state, batch):
        model.eval()
        with torch.no_grad():
            _, per_seq = loss_fn(batch, None, False)
        w = batch["weight"].float()
        return {"loss_sum": (per_seq * w).sum(), "count": w.sum()}

    return eval_step
