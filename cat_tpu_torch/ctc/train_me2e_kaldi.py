"""ME2E CTC with the kaldi-compatible framing (counterpart of
`cat_tpu/ctc/train_me2e_kaldi.py`): `train_me2e` with the front end's
kaldi_framing on by default (each frame's DC offset removed and a 0.97
pre-emphasis before the povey window, no dither) and the `noSE` spelling
of no_enhance (the reference channel as it is, no mask net and no
beamformer). The steps are `train_me2e`'s."""
from __future__ import annotations

from cat_tpu_torch.ctc import train_me2e
from cat_tpu_torch.ctc.train_me2e import (Me2eModel, init_state,  # noqa: F401
                                          make_eval_step, make_train_step)


def build_model(cfg: dict, num_classes: int, device=None,
                seed: int = 0) -> Me2eModel:
    return train_me2e.build_model(cfg, num_classes, device, seed, kaldi=True)
