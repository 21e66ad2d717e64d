"""Stages of the text-corpus pipelines (the n-gram pipeline,
`pipeline/ngram.py`, and the neural LM one, `pipeline/lm.py`):
counterpart of `stage_tokenizer` in `cat_tpu/pipeline/lm.py`."""
from __future__ import annotations

import os


def stage_tokenizer(expdir, hyper):
    """The experiment's tokenizer, loaded, or built from data.train, a
    raw text file of one sentence a line, and saved."""
    from cat_tpu_torch.utils import tokenizer as tknz

    cfg = hyper["tokenizer"]
    tpath = os.path.join(expdir, cfg.get("file", "tokenizer.tknz"))
    if os.path.exists(tpath):
        return tknz.load(tpath)
    opts = dict(cfg.get("option-init", {}))
    if "corpus" not in opts and cfg["type"] != "RawTokenizer":
        opts["corpus"] = hyper["data"]["train"]
    tok = tknz.initialize({"type": cfg["type"], "option-init": opts})
    tok.save(tpath)
    return tok
