"""CTC model assembly (counterpart of `cat_tpu/ctc/train.py`'s
`build_model`). The train step is a later slice of the port."""
from __future__ import annotations

import torch

from cat_tpu_torch import models


def build_model(cfg: dict, num_classes: int, device=None, seed: int = 0):
    """cfg: {"encoder": {"type": ..., "kwargs": {...}}}; the vocabulary size
    is injected. Weights are random, drawn from a generator seeded with
    `seed` (a checkpoint replaces them). Returns the model in eval mode on
    `device`, which defaults to "cuda" and raises when CUDA is missing:
    pass device="cpu" for the plain PyTorch path."""
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
