"""Joint-sequence G2P (counterpart of `cat_tpu/fst/g2p.py`), in the
role of Phonetisaurus, on the host:

  1. EM many-to-many alignment of (graphemes, phonemes) pairs:
     forward-backward over segmentations where each step consumes 1..max_g
     graphemes and emits 0..max_p phonemes.
  2. Viterbi-align the lexicon into "graphone" (g, p) token sequences.
  3. Interpolated-KN n-gram over graphone sequences (`fst/ngram.py`).
  4. Prediction: beam search over input-synchronized segmentations scored
     by the joint n-gram.
"""
from __future__ import annotations

import math
import pickle
from collections import defaultdict

from cat_tpu_torch.fst.ngram import BOS, EOS, train_ngram

EPS = "_"  # empty phoneme marker inside a graphone


def _chunks(seq, i, max_n):
    """All (sub, next_i) consuming 1..max_n items of seq at i."""
    for n in range(1, max_n + 1):
        if i + n <= len(seq):
            yield tuple(seq[i:i + n]), i + n


class G2P:
    """Trained joint-sequence G2P model."""

    def __init__(self, lm, max_g=2, max_p=2):
        self.lm = lm          # NGramLM over graphone tokens
        self.max_g = max_g
        self.max_p = max_p
        # index graphones by grapheme part for decode
        self.by_g = defaultdict(list)
        for (tok,) in lm.probs[1]:
            if isinstance(tok, str) and "}" in tok:
                g, p = tok.split("}", 1)
                self.by_g[tuple(g.split("|"))].append(tok)

    # -------------------- training --------------------

    @staticmethod
    def _align_probs(pairs, max_g, max_p, em_iters=8, cutoff=1e-6):
        """EM over joint segmentations → graphone probabilities."""
        # init: uniform over all co-occurring (g-chunk, p-chunk)
        probs = defaultdict(float)
        for gs, ps in pairs:
            for i in range(len(gs)):
                for gc, _ in _chunks(gs, i, max_g):
                    for j in range(len(ps)):
                        for pc, _ in _chunks(ps, j, max_p):
                            probs[(gc, pc)] += 1.0
                        probs[(gc, ())] += 0.01  # deletions, rare init
        total = sum(probs.values())
        probs = {k: v / total for k, v in probs.items()}

        for _ in range(em_iters):
            counts = defaultdict(float)
            for gs, ps in pairs:
                I, J = len(gs), len(ps)
                # forward
                a = [[0.0] * (J + 1) for _ in range(I + 1)]
                a[0][0] = 1.0
                for i in range(I + 1):
                    for j in range(J + 1):
                        if a[i][j] == 0.0:
                            continue
                        for gc, ni in _chunks(gs, i, max_g):
                            for dj in range(0, max_p + 1):
                                if j + dj > J:
                                    break
                                pc = tuple(ps[j:j + dj])
                                p = probs.get((gc, pc), 0.0)
                                if p > 0:
                                    a[ni][j + dj] += a[i][j] * p
                if a[I][J] == 0.0:
                    continue
                # backward
                b = [[0.0] * (J + 1) for _ in range(I + 1)]
                b[I][J] = 1.0
                for i in range(I, -1, -1):
                    for j in range(J, -1, -1):
                        for gc, ni in _chunks(gs, i, max_g):
                            for dj in range(0, max_p + 1):
                                if j + dj > J:
                                    break
                                pc = tuple(ps[j:j + dj])
                                p = probs.get((gc, pc), 0.0)
                                if p > 0 and b[ni][j + dj] > 0:
                                    b[i][j] += p * b[ni][j + dj]
                z = a[I][J]
                for i in range(I + 1):
                    for j in range(J + 1):
                        if a[i][j] == 0.0:
                            continue
                        for gc, ni in _chunks(gs, i, max_g):
                            for dj in range(0, max_p + 1):
                                if j + dj > J:
                                    break
                                pc = tuple(ps[j:j + dj])
                                p = probs.get((gc, pc), 0.0)
                                if p > 0:
                                    post = a[i][j] * p * b[ni][j + dj] / z
                                    if post > cutoff:
                                        counts[(gc, pc)] += post
            total = sum(counts.values())
            if total == 0:
                break
            probs = {k: v / total for k, v in counts.items()}
        return probs

    @staticmethod
    def _viterbi_align(gs, ps, probs, max_g, max_p):
        """Best graphone segmentation of one entry, or None."""
        I, J = len(gs), len(ps)
        NEG = -1e30
        best = [[NEG] * (J + 1) for _ in range(I + 1)]
        back = [[None] * (J + 1) for _ in range(I + 1)]
        best[0][0] = 0.0
        for i in range(I + 1):
            for j in range(J + 1):
                if best[i][j] <= NEG:
                    continue
                for gc, ni in _chunks(gs, i, max_g):
                    for dj in range(0, max_p + 1):
                        if j + dj > J:
                            break
                        pc = tuple(ps[j:j + dj])
                        p = probs.get((gc, pc), 0.0)
                        if p <= 0:
                            continue
                        s = best[i][j] + math.log(p)
                        if s > best[ni][j + dj]:
                            best[ni][j + dj] = s
                            back[ni][j + dj] = (i, j, gc, pc)
        if best[I][J] <= NEG:
            return None
        out = []
        i, j = I, J
        while (i, j) != (0, 0):
            pi, pj, gc, pc = back[i][j]
            out.append(graphone(gc, pc))
            i, j = pi, pj
        return out[::-1]

    @classmethod
    def train(cls, lexicon, max_g=2, max_p=2, em_iters=8, order=5):
        """lexicon: iterable of (word:str, phones:list[str]).

        Words are split into characters; multi-entry words allowed."""
        pairs = [(tuple(w), tuple(ph)) for w, ph in lexicon]
        probs = cls._align_probs(pairs, max_g, max_p, em_iters)
        seqs = []
        for gs, ps in pairs:
            al = cls._viterbi_align(gs, ps, probs, max_g, max_p)
            if al is not None:
                seqs.append(al)
        lm = train_ngram(seqs, order=order)
        return cls(lm, max_g, max_p)

    # -------------------- prediction --------------------

    def predict(self, word, nbest=1, beam=16):
        """word → up to nbest (phones:list[str], logprob) hypotheses."""
        gs = tuple(word)
        I = len(gs)
        k = self.lm.order - 1
        init_ctx = (BOS,) * k if k > 0 else ()
        # beams[i] = list of (lm_context, phones, log10 score)
        beams = {0: [(init_ctx, (), 0.0)]}
        for i in range(I):
            if i not in beams:
                continue
            cur = beams.pop(i)
            cur.sort(key=lambda x: -x[2])
            for ctx, phones, score in cur[:beam]:
                for gc, ni in _chunks(gs, i, self.max_g):
                    for tok in self.by_g.get(gc, ()):
                        lp = self.lm.logp(ctx, tok)
                        nctx = (ctx + (tok,))[-k:] if k > 0 else ()
                        _, p = tok.split("}", 1)
                        new_ph = phones + (tuple(
                            p.split("|")) if p != EPS else ())
                        beams.setdefault(ni, []).append(
                            (nctx, new_ph, score + lp))
        finals = []
        for ctx, phones, score in beams.get(I, []):
            lp = self.lm.logp(ctx, EOS)
            finals.append((list(sum([list(x) for x in phones], [])),
                           score + lp))
        finals.sort(key=lambda x: -x[1])
        # dedupe identical phone sequences
        seen, out = set(), []
        for ph, sc in finals:
            key = tuple(ph)
            if key in seen:
                continue
            seen.add(key)
            out.append((ph, sc))
            if len(out) >= nbest:
                break
        return out

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path):
        with open(path, "rb") as f:
            return pickle.load(f)


def graphone(gc, pc):
    """(g-chunk, p-chunk) → 'g1|g2}p1|p2' token (Phonetisaurus style)."""
    g = "|".join(gc)
    p = "|".join(pc) if pc else EPS
    return f"{g}}}{p}"
