"""N-best list utilities (a copy of `cat_tpu/utils/nbest.py`, kept in
the port so that it imports nothing of the JAX package): the pickle
format {uid: {bid: (score, text)}} that the decode stage writes, text to
n-best and back, and the weighted interpolation of n-best lists."""
from __future__ import annotations

import pickle


def read_nbest(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def write_nbest(nbest, path):
    with open(path, "wb") as f:
        pickle.dump(nbest, f)


def text_to_nbest(text_path):
    """'uid hyp' lines → 1-best nbest dict (text2nbest)."""
    out = {}
    with open(text_path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if parts:
                out[parts[0]] = {0: (0.0, parts[1] if len(parts) > 1
                                     else "")}
    return out


def nbest_to_text(nbest, out_path):
    with open(out_path, "w") as f:
        for uid in sorted(nbest):
            best = max(nbest[uid].items(), key=lambda kv: kv[1][0])
            f.write(f"{uid}\t{best[1][1]}\n")


def interpolate_nbests(nbests, weights):
    """Weighted score combination across systems covering the same
    hypotheses (interpolate_nbests.py): for hypotheses present in
    multiple lists, score = Σ w_i · score_i; unseen entries keep their
    own weighted score."""
    out = {}
    for nb, w in zip(nbests, weights):
        for uid, hyps in nb.items():
            slot = out.setdefault(uid, {})
            for _, (score, text) in hyps.items():
                if text in slot:
                    slot[text] += w * score
                else:
                    slot[text] = w * score
    return {uid: {i: (s, t) for i, (t, s) in
                  enumerate(sorted(hyps.items(), key=lambda kv: -kv[1]))}
            for uid, hyps in out.items()}
