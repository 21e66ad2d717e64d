"""RNN-T decoding: greedy and beam search (counterpart of
`cat_tpu/rnnt/decode.py`).

- `make_greedy_decoder`: the encoder once, then a loop over frames with
  a bounded inner loop of at most `max_symbols` emissions a frame; after
  a blank nothing more is emitted in that frame. The batch stays on the
  model's device; the inner loop stops early once no utterance emits
  (the later inner steps would change nothing).
- `RNNTBeamDecoder`: the search runs on the host, with every (utterance
  × beam) predictor and joiner evaluation of a frame batched into one
  call each; shallow fusion with an n-gram (`fst.ngram.NGramLM`, or
  `CombinedLM`), a length reward and internal-LM subtraction.

`main` is the decode CLI, the port's stand-in for the pipeline's RNN-T
decode stage:

    python -m cat_tpu_torch.rnnt.decode <expdir> --mode beam

reading a `cat_tpu.rnnt.train` experiment (`hyper-p.json`,
`config.json`, tokenizer, `pkl/<split>`, best checkpoint, of either
package). `--lm` needs
ARPA IO and `--mode streaming` the unified trainer, both later slices
(ROADMAP.md).
"""
from __future__ import annotations

import math

import numpy as np
import torch

LN10 = math.log(10.0)
# the trainer modules a `cat_tpu` experiment may name, and the port's own
_TRAIN_BINS = {"cat_tpu.rnnt.train": "cat_tpu_torch.rnnt.train",
               "cat_tpu_torch.rnnt.train": "cat_tpu_torch.rnnt.train"}


def _tree_map(fn, *trees):
    """fn over the leaves of nested tuples (a predictor state)."""
    if isinstance(trees[0], (tuple, list)):
        return tuple(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _device(model):
    return next(model.parameters()).device


def make_greedy_decoder(model, blank=0, max_symbols=4, max_out=200):
    """Returns decode(feats, flens) -> (tokens (N, max_out), counts (N,)),
    int64 tensors on the model's device; utterance n's hypothesis is
    tokens[n, :counts[n]]."""

    def decode(feats, flens):
        dev = _device(model)
        feats = torch.as_tensor(feats, dtype=torch.float32, device=dev)
        flens = torch.as_tensor(flens, device=dev)
        with torch.inference_mode():
            enc, olens = model.encode(feats, flens)
            N, T, _ = enc.shape
            state = model.predictor.init_state(N, dev)
            pred, state = model.predict_step(
                torch.zeros(N, dtype=torch.long, device=dev), state)
            tokens = torch.zeros(N, max_out, dtype=torch.long, device=dev)
            counts = torch.zeros(N, dtype=torch.long, device=dev)
            n_idx = torch.arange(N, device=dev)
            for t in range(min(T, int(olens.max()))):
                alive = t < olens
                for _ in range(max_symbols):
                    best = model.join(enc[:, t], pred).argmax(-1)
                    emit = alive & (best != blank) & (counts < max_out)
                    if not bool(emit.any()):
                        break
                    slot = counts.clamp_max(max_out - 1)
                    tokens[n_idx, slot] = torch.where(emit, best,
                                                      tokens[n_idx, slot])
                    counts += emit.long()
                    new_pred, new_state = model.predict_step(best, state)
                    pred = torch.where(emit[:, None], new_pred, pred)
                    state = _tree_map(
                        lambda a, b: torch.where(emit[:, None], a, b),
                        new_state, state)
                    alive = emit
        return tokens, counts

    return decode


class CombinedLM:
    """Weighted combination of LM scorers (e.g. an n-gram with a negative
    weight for LODR). Each scorer has logp(context, tok) in log10; the
    weights apply on top of the decoder's alpha."""

    def __init__(self, lms_and_weights):
        self.parts = list(lms_and_weights)

    def logp(self, context, tok):
        return sum(w * lm.logp(context, tok) for lm, w in self.parts)


class RNNTBeamDecoder:
    """Host beam search with batched predictor and joiner steps on the
    model's device. Options: beam width, shallow fusion (`lm` with
    logp(context, tok) in log10, weight `alpha`), length reward `beta`,
    internal-LM subtraction (`ilm_weight`: the joiner with a zero encoder
    contribution, subtracted from the label scores)."""

    def __init__(self, model, beam_width=8, blank=0, lm=None, alpha=0.0,
                 beta=0.0, joiner_normalized=False, ilm_weight=0.0):
        from cat_tpu_torch.models.joiner import HAT, LogAdd

        self.model = model
        self.W = beam_width
        self.blank = blank
        self.lm = lm
        self.alpha = alpha
        self.beta = beta
        # LogAdd and HAT joiners give log-probs at decode steps
        self.joiner_normalized = joiner_normalized or isinstance(
            model.joiner, (LogAdd, HAT))
        self.ilm_weight = ilm_weight
        self.dev = _device(model)

    def _pred_step(self, tokens, state):
        """Host arrays in and out: tokens (M,), a state tree of (M, ...)."""
        to_dev = lambda x: torch.as_tensor(x, device=self.dev)
        with torch.inference_mode():
            out, st = self.model.predict_step(to_dev(tokens),
                                              _tree_map(to_dev, state))
        return out.cpu().numpy(), _tree_map(lambda x: x.cpu().numpy(), st)

    def _join(self, enc_rows, pred_rows):
        """(M, V) host log-probs of the joiner on host rows."""
        with torch.inference_mode():
            enc = torch.as_tensor(enc_rows, device=self.dev)
            pred = torch.as_tensor(pred_rows, device=self.dev)
            lp = self.model.join(enc, pred)
            if not self.joiner_normalized:
                lp = torch.log_softmax(lp, -1)
            if self.ilm_weight != 0.0:
                ilm = torch.log_softmax(
                    self.model.join(torch.zeros_like(enc), pred), -1)
                # internal LM subtracted from the label scores only
                lp = torch.cat([lp[..., :1], lp[..., 1:]
                                - self.ilm_weight * ilm[..., 1:]], -1)
        return lp.cpu().numpy()

    def _lm_score(self, prefix, tok):
        if self.lm is None:
            return self.beta
        return self.alpha * self.lm.logp(tuple(prefix), tok) * LN10 \
            + self.beta

    def decode(self, feats, flens, nbest=1):
        """feats (N, T, F), flens (N,), arrays or tensors -> per utterance,
        [(score, [tokens])] best first."""
        with torch.inference_mode():
            enc, olens = self.model.encode(
                torch.as_tensor(feats, dtype=torch.float32, device=self.dev),
                torch.as_tensor(flens, device=self.dev))
        enc = enc.float().cpu().numpy()
        olens = olens.cpu().numpy()
        N, T, _ = enc.shape
        W = self.W

        state0 = _tree_map(lambda x: x.cpu().numpy(),
                           self.model.predictor.init_state(N))
        out0, st0 = self._pred_step(np.zeros(N, np.int64), state0)

        def state_slice(st, idx):
            return _tree_map(lambda x: x[idx], st)

        # beams[n]: list of dict(prefix, score, pred_out, pred_state)
        beams = [[dict(prefix=(), score=0.0, pred_out=out0[n],
                       pred_state=state_slice(st0, n))] for n in range(N)]

        for t in range(T):
            active = [n for n in range(N) if t < olens[n]]
            if not active:
                break
            flat = [(n, b) for n in active for b in beams[n]]
            logp = self._join(np.stack([enc[n, t] for n, _ in flat]),
                              np.stack([b["pred_out"] for _, b in flat]))

            # the predictor state is a function of the prefix, so merging
            # hypotheses of one prefix is a logaddexp of their scores
            new_beams = {n: {} for n in active}

            def merge(n, prefix, sc, pred_out=None, pred_state=None,
                      parent=None):
                cand = new_beams[n].get(prefix)
                if cand is None:
                    new_beams[n][prefix] = dict(
                        prefix=prefix, score=sc, pred_out=pred_out,
                        pred_state=pred_state, parent=parent)
                else:
                    cand["score"] = float(np.logaddexp(cand["score"], sc))
                    if cand["pred_out"] is None and pred_out is not None:
                        cand["pred_out"] = pred_out
                        cand["pred_state"] = pred_state
                        cand["parent"] = None

            for m, (n, b) in enumerate(flat):
                merge(n, b["prefix"], b["score"] + float(logp[m, self.blank]),
                      pred_out=b["pred_out"], pred_state=b["pred_state"])
                for vtok in np.argsort(logp[m])[::-1][:W]:
                    if vtok == self.blank:
                        continue
                    ntok = int(vtok)
                    sc = (b["score"] + float(logp[m, ntok])
                          + self._lm_score(b["prefix"], ntok))
                    merge(n, b["prefix"] + (ntok,), sc, parent=(m, ntok))
            # prune to W per utterance
            kept = []
            for n in active:
                beams[n] = sorted(new_beams[n].values(),
                                  key=lambda e: -e["score"])[:W]
                kept += [e for e in beams[n] if e.get("pred_out") is None]
            # one batched predictor step for the surviving new prefixes
            if kept:
                parents = [flat[e["parent"][0]][1] for e in kept]
                toks = np.asarray([e["parent"][1] for e in kept], np.int64)
                pstates = _tree_map(lambda *xs: np.stack(xs),
                                    *[p["pred_state"] for p in parents])
                new_out, new_state = self._pred_step(toks, pstates)
                for j, e in enumerate(kept):
                    e["pred_out"] = new_out[j]
                    e["pred_state"] = state_slice(new_state, j)
                    e.pop("parent", None)

        results = []
        for n in range(N):
            ranked = sorted(beams[n], key=lambda e: -e["score"])[:nbest]
            results.append([(e["score"], list(e["prefix"])) for e in ranked])
        return results


def main(argv=None):
    """Decode CLI: per-utterance encoder forward and search, writing
    `decode_<split>.txt`, its n-best pickle, and the real-time factor."""
    import argparse
    import importlib
    import json
    import os
    import pickle
    import time

    from cat_tpu_torch.utils import tokenizer as tknz
    from cat_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                model_weights)
    from cat_tpu_torch.utils.data import SpeechDataset

    p = argparse.ArgumentParser("cat_tpu_torch.rnnt.decode")
    p.add_argument("expdir")
    p.add_argument("--split", default="dev")
    p.add_argument("--mode", default="beam",
                   choices=["greedy", "beam", "streaming"])
    p.add_argument("--beam-width", type=int, default=16)
    p.add_argument("--nbest", type=int, default=1)
    p.add_argument("--lm", default=None, help="ARPA path for fusion")
    p.add_argument("--alpha", type=float, default=0.0)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--ilm-weight", type=float, default=0.0)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda",
                   help="device of the model (default cuda)")
    args = p.parse_args(argv)
    if args.mode == "streaming" or args.lm:
        raise NotImplementedError(
            "streaming decoding needs the unified transducer and --lm "
            "fusion ARPA IO, neither ported to cat_tpu_torch yet; see "
            "ROADMAP.md")

    def load_json(name):
        with open(os.path.join(args.expdir, name)) as f:
            return json.load(f)

    hyper = load_json("hyper-p.json")
    config = load_json("config.json")
    tok = tknz.load(os.path.join(
        args.expdir, hyper["tokenizer"].get("file", "tokenizer.tknz")))
    train_bin = hyper["train"]["bin"]
    if train_bin not in _TRAIN_BINS:
        raise NotImplementedError(f"trainer {train_bin!r} is not ported to "
                                  "cat_tpu_torch.rnnt yet; see ROADMAP.md")
    task = importlib.import_module(_TRAIN_BINS[train_bin])
    model = task.build_model(config, num_classes=tok.vocab_size,
                             device=args.device)
    ckpt = CheckpointManager(os.path.join(args.expdir, "check"))
    model.load_state_dict(model_weights(model, ckpt.path(ckpt.best())))
    ds = SpeechDataset(os.path.join(args.expdir, "pkl", args.split))
    if args.mode == "greedy":
        greedy = make_greedy_decoder(model)
    else:
        beam = RNNTBeamDecoder(model, beam_width=args.beam_width,
                               alpha=args.alpha, beta=args.beta,
                               ilm_weight=args.ilm_weight)

    t0 = time.time()
    audio_s = 0.0
    hyps, nbest_out = {}, {}
    for i in range(len(ds)):
        f, _ = ds[i]
        f = np.array(f, np.float32)  # a writable copy of the memmap
        audio_s += f.shape[0] * 0.01
        if args.mode == "greedy":
            toks, counts = greedy(f[None], [f.shape[0]])
            res = [(0.0, toks[0, :int(counts[0])].tolist())]
        else:
            res = beam.decode(f[None], [f.shape[0]], nbest=args.nbest)[0]
        uid = ds.uids[i]
        hyps[uid] = tok.decode(list(res[0][1]))
        nbest_out[uid] = {b: (s, tok.decode(list(pre)))
                          for b, (s, pre) in enumerate(res)}
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
