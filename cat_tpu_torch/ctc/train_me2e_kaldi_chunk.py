"""Chunk-based ME2E CTC with the kaldi-compatible framing (counterpart of
`cat_tpu/ctc/train_me2e_kaldi_chunk.py`): `train_me2e_chunk` with the
front end built as `train_me2e_kaldi` builds it (kaldi_framing on by
default, `noSE` read as no_enhance)."""
from __future__ import annotations

from cat_tpu_torch.ctc import train_me2e_chunk
from cat_tpu_torch.ctc.train_me2e_chunk import (  # noqa: F401
    ChunkMe2eModel, bf_chunk_infer, init_state, make_eval_step,
    make_train_step)


def build_model(cfg: dict, num_classes: int, device=None,
                seed: int = 0) -> ChunkMe2eModel:
    return train_me2e_chunk.build_model(cfg, num_classes, device, seed,
                                        kaldi=True)
