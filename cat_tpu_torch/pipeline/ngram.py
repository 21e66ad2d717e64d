"""N-gram LM pipeline: tokenize -> count -> ARPA -> perplexity
(counterpart of `cat_tpu/pipeline/ngram.py`), with the port's
Kneser-Ney trainer, on the host:

    python -m cat_tpu_torch.pipeline.ngram <expdir> [--order N]

reads expdir/hyper-p.json ({"data": {"train", "dev"}, "tokenizer",
"ngram": {"order"}}; the data are text files of one sentence a line) and
writes <order>gram.arpa and ngram.json (the dev perplexity) there.
"""
from __future__ import annotations

import argparse
import json
import os

from cat_tpu_torch.fst.ngram import train_ngram, write_arpa
from cat_tpu_torch.pipeline.asr import load_json
from cat_tpu_torch.pipeline.text import stage_tokenizer


def main(argv=None):
    p = argparse.ArgumentParser("cat_tpu_torch.pipeline.ngram")
    p.add_argument("expdir")
    p.add_argument("--order", type=int, default=None)
    args = p.parse_args(argv)
    hyper = load_json(os.path.join(args.expdir, "hyper-p.json"))
    order = args.order or hyper.get("ngram", {}).get("order", 3)
    tok = stage_tokenizer(args.expdir, hyper)

    def read_ids(path):
        with open(path) as f:
            return [tok.encode(line.strip()) for line in f
                    if line.strip()]

    lm = train_ngram(read_ids(hyper["data"]["train"]), order=order)
    arpa_path = os.path.join(args.expdir, f"{order}gram.arpa")
    write_arpa(lm, arpa_path)
    result = {"arpa": arpa_path, "order": order}
    if "dev" in hyper.get("data", {}):
        result["dev_ppl"] = lm.perplexity(read_ids(hyper["data"]["dev"]))
    with open(os.path.join(args.expdir, "ngram.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
