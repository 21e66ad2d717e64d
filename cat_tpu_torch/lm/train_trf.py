"""TRF LM trainer, NCE and dynamic NCE (counterpart of
`cat_tpu/lm/train_trf.py`); hyper["train"]["bin"] =
"cat_tpu.lm.train_trf" (or the port's name).

config.json:
  "decoder": {"type": "TRFNCE", "kwargs": {
      "energy_func": ..., "max_len": ..., "zeta_factor": ...,
      "method": "nce" | "dnce", "noise_rate": 1.0, "alpha": 0.25,
      "noise_max_len": 64, "greedy_sampling": false,
      "ebm": {"type", "kwargs"}, "noise": {"type", "kwargs"}}}

The length prior π comes from the packed train corpus. A train step
clips at 5 and steps the optimizer at the scheduler's lr (`ctc/train.py`
`make_step`); the dev metric is the NCE classification loss
(`loss_true`) with the noise drawn from a generator seeded anew with
1234 at every eval batch, so evaluations compare.
"""
from __future__ import annotations

import numpy as np
import torch

from cat_tpu_torch.ctc.train import init_state, make_step  # noqa: F401
from cat_tpu_torch.lm.trf import TRFNCE, hist_length, make_trf_loss
from cat_tpu_torch.utils.data_prep import check_device

# kwargs of the loss, not of the module
_LOSS_KEYS = ("method", "noise_rate", "alpha", "noise_max_len",
              "greedy_sampling")
EVAL_SEED = 1234


def build_model(cfg: dict, num_classes: int, device=None,
                seed: int = 0) -> TRFNCE:
    """The `TRFNCE` of cfg["decoder"]["kwargs"] over num_classes tokens,
    random weights from a generator seeded with `seed`, in eval mode on
    `device` (default "cuda")."""
    device = check_device(device)
    kw = dict(cfg["decoder"].get("kwargs", {}))
    for k in _LOSS_KEYS:
        kw.pop(k, None)
    kw["vocab_size"] = num_classes
    model = TRFNCE(**kw, generator=torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def loss_options(cfg: dict) -> dict:
    kw = cfg["decoder"].get("kwargs", {})
    return {"method": kw.get("method", "nce"),
            "noise_rate": kw.get("noise_rate", 1.0),
            "alpha": kw.get("alpha", 0.25),
            "max_len": kw.get("noise_max_len", 64),
            "greedy_sampling": kw.get("greedy_sampling", False)}


def length_prior(dataset, max_len: int = 200) -> np.ndarray:
    """π over the corpus's sequence lengths + 1 (capped at max_len - 1)."""
    lens = [min(dataset.token_length(i) + 1, max_len - 1)
            for i in range(len(dataset))]
    return hist_length(np.asarray(lens), max_len)


def make_train_step(model: TRFNCE, optimizer, pi, opts: dict,
                    grad_clip=5.0):
    """train_step(state, batch, lr, gen) -> (state, metrics): "loss",
    "grad_norm", "skipped" and the loss's own terms."""
    trf_loss = make_trf_loss(model, pi, **opts)

    def loss_fn(batch, gen, train):
        loss, metrics = trf_loss(batch, gen)
        return loss, None, metrics

    return make_step(model, optimizer, loss_fn, grad_clip)


def make_eval_step(model: TRFNCE, pi, opts: dict):
    """eval_step(state, batch) -> {"loss_sum": loss_true · B, "count": B}:
    the NCE loss's `loss_true` with noise from a fixed seed."""
    loss_fn = make_trf_loss(model, pi, **{**opts, "method": "nce"})

    def eval_step(state, batch):
        model.eval()
        gen = torch.Generator().manual_seed(EVAL_SEED)
        with torch.no_grad():
            _, metrics = loss_fn(batch, gen)
        B = batch["tokens"].shape[0]
        return {"loss_sum": metrics["loss_true"] * B, "count": float(B)}

    return eval_step
