"""Perplexity of an n-gram or a neural LM on a text file (counterpart of
`cat_tpu/lm/ppl.py`).

    python -m cat_tpu_torch.lm ppl LM.arpa[.gz]|LM_EXPDIR TEXT
        [--device cuda|cpu]

prints {"ppl": value}; one sentence a line, tokenized by the LM
experiment's tokenizer (an ARPA file's words split on spaces).
"""
from __future__ import annotations

import argparse
import json


def ppl_ngram(arpa_path, text_path):
    from cat_tpu_torch.fst.ngram import read_arpa

    lm = read_arpa(arpa_path)
    with open(text_path) as f:
        sents = [line.split() for line in f if line.strip()]
    return lm.perplexity(sents)


def ppl_neural(expdir, text_path, device=None):
    from cat_tpu_torch.lm.train import load_exp, perplexity

    model, tok = load_exp(expdir, device)
    with open(text_path) as f:
        seqs = [tok.encode(line.strip()) for line in f if line.strip()]
    return perplexity(model, seqs)


def main(argv=None):
    p = argparse.ArgumentParser("cat_tpu_torch.lm.ppl")
    p.add_argument("model", help="expdir (neural) or .arpa path (ngram)")
    p.add_argument("text")
    p.add_argument("--device", default="cuda",
                   help="device of a neural LM (default cuda)")
    args = p.parse_args(argv)
    if args.model.endswith((".arpa", ".arpa.gz")):
        value = ppl_ngram(args.model, args.text)
    else:
        value = ppl_neural(args.model, args.text, args.device)
    print(json.dumps({"ppl": value}))


if __name__ == "__main__":
    main()
