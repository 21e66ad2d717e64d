"""N-best rescoring: score = am + α·lm + β·len (counterpart of
`cat_tpu/lm/rescore.py`), with n-gram LMs (`fst.ngram.NGramLM`) or neural
LMs (`lm.train.sentence_nll` on the LM's device), and the α/β grid search
on a dev n-best list.

    python -m cat_tpu_torch.lm.rescore NBEST.pkl LM.arpa[.gz]|LM_EXPDIR \
        [--alpha A] [--beta B] [--ref TEXT] [--search] [--output OUT] \
        [--device cuda|cpu]
"""
from __future__ import annotations

import math

LN10 = math.log(10.0)


def rescore_nbest(nbest, lm_nll, alpha=1.0, beta=0.0):
    """nbest: {uid: {bid: (am_score, tokens_or_text)}}; lm_nll:
    {(uid, bid): nll_nats}. Returns {uid: best (score, hyp)}.

    score = am_score − α·nll + β·len (am_score is a log-prob)."""
    out = {}
    for uid, hyps in nbest.items():
        best = None
        for bid, (am, hyp) in hyps.items():
            L = len(hyp.split()) if isinstance(hyp, str) else len(hyp)
            score = am - alpha * lm_nll[(uid, bid)] + beta * L
            if best is None or score > best[0]:
                best = (score, hyp)
        out[uid] = best
    return out


def ngram_nll(lm, nbest, tokenizer=None):
    """{(uid,bid): nll nats} using a backoff n-gram LM."""
    out = {}
    for uid, hyps in nbest.items():
        for bid, (_, hyp) in hyps.items():
            toks = hyp.split() if isinstance(hyp, str) else list(hyp)
            out[(uid, bid)] = -lm.score_sentence(toks) * LN10
    return out


def neural_nll(model, nbest, tokenizer):
    """{(uid,bid): nll nats} of a neural LM over token ids (a text
    hypothesis encoded by `tokenizer`)."""
    from cat_tpu_torch.lm.train import sentence_nll

    keys, seqs = [], []
    for uid, hyps in nbest.items():
        for bid, (_, hyp) in hyps.items():
            keys.append((uid, bid))
            seqs.append(tokenizer.encode(hyp) if isinstance(hyp, str)
                        else list(hyp))
    nll = sentence_nll(model, seqs)
    return {k: float(v) for k, v in zip(keys, nll)}


def search_lm_weight(nbest, lm_nll, refs, alphas, betas=(0.0,),
                     char_level=False, tokenizer=None):
    """Grid-search α/β by WER on a dev n-best list. Returns the best
    {"wer", "alpha", "beta"}, the first of equals in grid order."""
    from cat_tpu_torch.utils.wer import wer

    best = None
    for a in alphas:
        for b in betas:
            res = rescore_nbest(nbest, lm_nll, a, b)
            hyps = {}
            for uid, (_, hyp) in res.items():
                if not isinstance(hyp, str):
                    hyp = (tokenizer.decode(list(hyp)) if tokenizer
                           else " ".join(map(str, hyp)))
                hyps[uid] = hyp
            w = wer(refs, hyps, char_level=char_level)["wer"]
            if best is None or w < best[0]:
                best = (w, a, b)
    return {"wer": best[0], "alpha": best[1], "beta": best[2]}


def main(argv=None):
    """Rescoring CLI: an n-best pickle and an ARPA LM or a neural LM's
    experiment directory -> the rescored 1-best text, and its WER against
    --ref."""
    import argparse
    import json
    import pickle

    from cat_tpu_torch.fst.ngram import read_arpa
    from cat_tpu_torch.utils.wer import wer

    p = argparse.ArgumentParser("cat_tpu_torch.lm.rescore")
    p.add_argument("nbest", help="pickle {uid: {bid: (score, text)}}")
    p.add_argument("lm", help=".arpa path or LM expdir")
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--ref", default=None, help="text file 'uid ref'")
    p.add_argument("--search", action="store_true",
                   help="grid-search alpha/beta on --ref")
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda",
                   help="device of a neural LM (default cuda)")
    args = p.parse_args(argv)

    with open(args.nbest, "rb") as f:
        nbest = pickle.load(f)
    if args.lm.endswith((".arpa", ".arpa.gz")):
        nll = ngram_nll(read_arpa(args.lm), nbest)
    else:
        from cat_tpu_torch.lm.train import load_exp

        model, tok = load_exp(args.lm, args.device)
        nll = neural_nll(model, nbest, tok)

    refs = {}
    if args.ref:
        with open(args.ref) as f:
            for line in f:
                parts = line.strip().split(None, 1)
                if len(parts) == 2:
                    refs[parts[0]] = parts[1]
    if args.search and refs:
        found = search_lm_weight(
            nbest, nll, refs,
            alphas=[0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0],
            betas=[-1.0, 0.0, 1.0])
        print(json.dumps(found))
        args.alpha, args.beta = found["alpha"], found["beta"]
    res = rescore_nbest(nbest, nll, args.alpha, args.beta)
    out = args.output or args.nbest + ".rescored.txt"
    with open(out, "w") as f:
        for uid in sorted(res):
            f.write(f"{uid}\t{res[uid][1]}\n")
    if refs:
        hyps = {uid: res[uid][1] for uid in res}
        print(json.dumps(wer(refs, hyps)))


if __name__ == "__main__":
    main()
