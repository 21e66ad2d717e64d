"""CTC decoding: the encoder on the card, greedy or prefix beam search on
the host (counterpart of `cat_tpu/ctc/decode.py`).

`decode_batch` runs one padded batch through the encoder and searches
each utterance: greedily, by prefix beam (fused with an n-gram when `lm`
is given) or through a TLG graph (`fst.decode.WfstDecoder`); `main` is
the decode CLI:

    python -m cat_tpu_torch.ctc.decode <expdir> --mode beam [--lm LM.arpa]
    python -m cat_tpu_torch.ctc.decode <expdir> --mode wfst \
        --graph TLG.npz [--words WORDS.txt]

reading the experiment's `hyper-p.json`, `config.json`, tokenizer,
`pkl/<split>` dataset and best checkpoint, as written by `cat_tpu` or by
the port's `Manager`. `--lm` is a token ARPA file (tokens read as ids);
`--words` holds "word id" lines. The CLI's WFST search is the Python
`WfstDecoder.decode` at beam 17 and max_active 7000, as in the JAX
package; the pipeline's stage 4 takes the C++ core.
"""
from __future__ import annotations

import math
import os
from collections import defaultdict

import numpy as np
import torch

NEG_INF = -1e30


def _lae(a, b):
    if a <= NEG_INF / 2:
        return b
    if b <= NEG_INF / 2:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def greedy_decode(log_probs, lengths, blank=0):
    """(N, T, V) log-probs (tensor or array) -> list[list[int]]: best path,
    repeats collapsed, blanks dropped."""
    path = torch.as_tensor(log_probs).argmax(dim=-1).cpu().numpy()
    lengths = torch.as_tensor(lengths).cpu().numpy()
    out = []
    for n in range(path.shape[0]):
        seq, prev = [], -1
        for s in path[n, : lengths[n]]:
            if s != prev and s != blank:
                seq.append(int(s))
            prev = int(s)
        out.append(seq)
    return out


def prefix_beam_search(log_probs, length, beam_width=16, blank=0,
                       lm=None, alpha=0.0, beta=0.0, lm_sym=None,
                       nbest=1):
    """Prefix beam search for ONE utterance.

    log_probs: (T, V) numpy log-softmax. Optional n-gram fusion: `lm` has
    `logp(context, word)` in log10 over token ids (or over symbols via
    `lm_sym`, id -> symbol); score += alpha·log10 p_lm + beta per token.

    Returns list of (score, prefix tuple) sorted best-first.
    """
    lp = np.asarray(log_probs)[:int(length)]
    T, V = lp.shape
    LN10 = math.log(10.0)

    def lm_score(prefix, tok):
        if lm is None:
            return beta  # insertion bonus applies with or without LM
        ctx = tuple(lm_sym(t) if lm_sym else t for t in prefix)
        w = lm_sym(tok) if lm_sym else tok
        return alpha * lm.logp(ctx, w) * LN10 + beta

    # beams: prefix -> (p_blank, p_nonblank, lm_total)
    beams = {(): (0.0, NEG_INF, 0.0)}
    for t in range(T):
        row = lp[t]
        # prune vocab: consider top candidates + blank
        cand = np.argsort(row)[::-1][: max(beam_width * 2, 8)]
        if blank not in cand:
            cand = np.append(cand, blank)
        new = defaultdict(lambda: [NEG_INF, NEG_INF, 0.0])

        for prefix, (pb, pnb, lms) in beams.items():
            p_tot = _lae(pb, pnb)
            for v in cand:
                p = float(row[v])
                if v == blank:
                    e = new[prefix]
                    e[0] = _lae(e[0], p_tot + p)
                    e[2] = lms
                    continue
                last = prefix[-1] if prefix else None
                if v == last:
                    # repeat: extends non-blank stays same prefix
                    e = new[prefix]
                    e[1] = _lae(e[1], pnb + p)
                    e[2] = lms
                    # with blank in between: new prefix
                    np_prefix = prefix + (int(v),)
                    s = lm_score(prefix, int(v))
                    e2 = new[np_prefix]
                    e2[1] = _lae(e2[1], pb + p)
                    e2[2] = lms + s
                else:
                    np_prefix = prefix + (int(v),)
                    s = lm_score(prefix, int(v))
                    e2 = new[np_prefix]
                    e2[1] = _lae(e2[1], p_tot + p)
                    e2[2] = lms + s
        # prune to beam_width by total score incl. LM
        scored = []
        for prefix, (pb, pnb, lms) in new.items():
            scored.append((_lae(pb, pnb) + lms, prefix, (pb, pnb, lms)))
        scored.sort(key=lambda x: -x[0])
        beams = {p: st for _, p, st in scored[:beam_width]}

    final = [(_lae(pb, pnb) + lms, prefix)
             for prefix, (pb, pnb, lms) in beams.items()]
    final.sort(key=lambda x: -x[0])
    return final[:nbest]


def batch_prefix_beam_search(log_probs, lengths, **kw):
    """Loop wrapper over the batch; returns list of nbest lists."""
    out = []
    for n in range(np.shape(log_probs)[0]):
        out.append(prefix_beam_search(np.asarray(log_probs)[n],
                                      int(np.asarray(lengths)[n]), **kw))
    return out


def decode_batch(model, feats, lengths, mode="greedy", beam_width=16,
                 nbest=1, alpha=0.0, beta=0.0, lm=None, wfst=None):
    """Decode one padded batch: feats (N, T, F), lengths (N,), tensors or
    arrays. The encoder and log-softmax run on the model's device; the
    search runs on the host: "greedy", "beam" (fused with the n-gram `lm`
    when given) or "wfst" (the Python search of the `WfstDecoder`
    `wfst`). Returns, per utterance, a list of (score, token-id tuple)
    best-first (greedy gives one, scored 0.0); "wfst" gives word ids."""
    device = next(model.parameters()).device
    if not torch.is_tensor(feats):
        feats = np.array(feats, np.float32)  # a writable copy of a memmap
    feats = torch.as_tensor(feats, dtype=torch.float32, device=device)
    lengths = torch.as_tensor(lengths, device=device)
    with torch.inference_mode():
        logits, olen = model(feats, lengths)
        lp = torch.log_softmax(logits.float(), dim=-1)
    if mode == "greedy":
        return [[(0.0, tuple(h))] for h in greedy_decode(lp, olen)]
    if mode == "beam":
        return batch_prefix_beam_search(
            lp.cpu().numpy(), olen.cpu().numpy(), beam_width=beam_width,
            lm=lm, alpha=alpha, beta=beta, nbest=nbest)
    if mode == "wfst":
        lp, olen = lp.cpu().numpy(), olen.cpu().numpy()
        return [[(s, tuple(w)) for s, w in
                 wfst.decode(lp[n], int(olen[n]), nbest=nbest)]
                for n in range(lp.shape[0])]
    raise ValueError(f"decode_batch: mode must be 'greedy', 'beam' or "
                     f"'wfst', got {mode!r}")


def main(argv=None):
    """Decode CLI: per-utterance encoder forward + host search, writing
    `decode_<split>.txt`, its n-best pickle, and the real-time factor."""
    import argparse
    import json
    import pickle
    import time

    from cat_tpu_torch.pipeline.tasks import train_module
    from cat_tpu_torch.utils import tokenizer as tknz
    from cat_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                model_weights)
    from cat_tpu_torch.utils.data import SpeechDataset

    p = argparse.ArgumentParser("cat_tpu_torch.ctc.decode")
    p.add_argument("expdir")
    p.add_argument("--split", default="dev")
    p.add_argument("--mode", default="beam",
                   choices=["greedy", "beam", "wfst"])
    p.add_argument("--beam-width", type=int, default=16)
    p.add_argument("--nbest", type=int, default=1)
    p.add_argument("--lm", default=None, help="ARPA path for fusion")
    p.add_argument("--alpha", type=float, default=0.3)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--graph", default=None, help="TLG npz for wfst mode")
    p.add_argument("--words", default=None, help="word symtable (w id)")
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda",
                   help="device of the encoder (default cuda)")
    args = p.parse_args(argv)
    if args.mode == "wfst" and not args.graph:
        raise SystemExit("--graph TLG.npz required for wfst mode")

    def load_json(name):
        with open(os.path.join(args.expdir, name)) as f:
            return json.load(f)

    hyper = load_json("hyper-p.json")
    config = load_json("config.json")
    tok = tknz.load(os.path.join(
        args.expdir, hyper["tokenizer"].get("file", "tokenizer.tknz")))
    task = train_module(hyper["train"]["bin"], "ctc")
    model = task.build_model(config, num_classes=tok.vocab_size,
                             device=args.device)
    ckpt = CheckpointManager(os.path.join(args.expdir, "check"))
    model.load_state_dict(model_weights(model, ckpt.path(ckpt.best())))
    ds = SpeechDataset(os.path.join(args.expdir, "pkl", args.split))
    lm = wfst = None
    if args.lm:
        from cat_tpu_torch.fst.ngram import read_arpa
        lm = read_arpa(args.lm, to_int=True)
    id2word = {}
    if args.mode == "wfst":
        from cat_tpu_torch.fst.decode import WfstDecoder
        from cat_tpu_torch.fst.fst import Fst
        wfst = WfstDecoder(Fst.load(args.graph), beam=17.0, max_active=7000)
        if args.words:
            with open(args.words) as fh:
                for line in fh:
                    w, i = line.split()
                    id2word[int(i)] = w

    def text(seq):
        if args.mode == "wfst":
            return " ".join(id2word.get(w, str(w)) for w in seq)
        return tok.decode(list(seq))

    t0 = time.time()
    audio_s = 0.0
    hyps, nbest_out = {}, {}
    for i in range(len(ds)):
        f, _ = ds[i]
        audio_s += f.shape[0] * 0.01
        res = decode_batch(model, f[None], [f.shape[0]], args.mode,
                           beam_width=args.beam_width, nbest=args.nbest,
                           alpha=args.alpha, beta=args.beta, lm=lm,
                           wfst=wfst)[0]
        uid = ds.uids[i]
        hyps[uid] = text(res[0][1])
        nbest_out[uid] = {b: (s, text(pre)) for b, (s, pre) in enumerate(res)}
    wall = time.time() - t0
    out = args.output or os.path.join(args.expdir,
                                      f"decode_{args.split}.txt")
    with open(out, "w") as fh:
        for uid in sorted(hyps):
            fh.write(f"{uid}\t{hyps[uid]}\n")
    with open(out + ".nbest.pkl", "wb") as fh:
        pickle.dump(nbest_out, fh)
    print(f"decoded {len(hyps)} utts in {wall:.1f}s "
          f"(RTF {wall / max(audio_s, 1e-6):.4f})")


if __name__ == "__main__":
    main()
