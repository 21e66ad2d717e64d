"""Train bins and task adapters (counterpart of `get_task` in
`cat_tpu/pipeline/tasks.py`).

A recipe's `hyper-p.json` names its trainer by a "bin", a module of
either package ("cat_tpu.ctc.train" or "cat_tpu_torch.ctc.train"). This
module holds the one map from a bin to the port's trainer module, read by
both pipelines (`pipeline/asr.py`, `pipeline/lm.py`, which takes the
`lm.*` bins) and by both decode CLIs. The bins not ported yet raise
NotImplementedError naming their ROADMAP.md section. The JAX package
drives the ME2E, JSA and P2G bins through task adapters; the plain ASR
bins have none (`get_task` returns None), as in JAX.
"""
from __future__ import annotations

import importlib

PORTED = ("ctc.train", "rnnt.train", "ctc.train_unified",
          "rnnt.train_unified", "lm.train", "lm.train_trf")
# bins of the JAX package that the port does not have yet, with the
# ROADMAP.md section that ports them
NOT_PORTED = {
    "ctc.train_me2e": "§A.8", "ctc.train_me2e_chunk": "§A.8",
    "ctc.train_me2e_kaldi": "§A.8", "ctc.train_me2e_kaldi_chunk": "§A.8",
    "ctc.train_jsa": "§A.8", "p2g.train": "§A.8",
}
TASK_BINS = ("ctc.train_me2e", "ctc.train_me2e_chunk",
             "ctc.train_me2e_kaldi", "ctc.train_me2e_kaldi_chunk",
             "ctc.train_jsa", "p2g.train")


def bin_key(name: str) -> str:
    """The bin without its package: "cat_tpu.ctc.train" -> "ctc.train"."""
    for pre in ("cat_tpu_torch.", "cat_tpu."):
        if name.startswith(pre):
            return name[len(pre):]
    return name


def family(name: str) -> str:
    """"ctc", "rnnt", "lm" or "p2g": the bin's family (JAX tells the
    transducer bins by the prefix `cat_tpu.rnnt.`)."""
    return bin_key(name).split(".")[0]


def is_unified(name: str) -> bool:
    """A CUSIDE unified trainer's bin (`*.train_unified`)."""
    return bin_key(name).endswith("train_unified")


def _not_ported(name):
    sec = NOT_PORTED.get(bin_key(name))
    where = f"ROADMAP.md {sec}" if sec else "ROADMAP.md"
    return NotImplementedError(f"train bin {name!r} is not ported to "
                               f"cat_tpu_torch yet; see {where}")


def train_module(name: str, want_family: str | None = None):
    """The port's trainer module for the bin `name` of either package.
    want_family ("ctc", "rnnt" or "lm"): the caller takes only that
    family's bins."""
    key = bin_key(name)
    if key not in PORTED:
        raise _not_ported(name)
    if want_family is not None and family(name) != want_family:
        raise ValueError(f"train bin {name!r} is not a {want_family} "
                         "trainer")
    return importlib.import_module("cat_tpu_torch." + key)


def get_task(hyper):
    """The task adapter of the experiment's bin: None for the plain ASR
    bins, as in JAX; the ME2E, JSA and P2G bins raise (ROADMAP.md
    §A.8)."""
    b = hyper.get("train", {}).get("bin", "")
    if bin_key(b) in TASK_BINS:
        raise _not_ported(b)
    return None
