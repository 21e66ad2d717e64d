"""WFST Viterbi beam decoding over TLG graphs (counterpart of
`cat_tpu/fst/decode.py`).

`build_tlg` composes T ∘ min(det(L ∘ G)). `WfstDecoder` searches it by
token passing: an epsilon (non-emitting) closure each frame, beam and
max-active pruning, backpointer traceback to the word sequence. Three
searches share its arc tables: `decode`, the Python reference (n-best
from the best token of each state); `decode_native`, the same 1-best
through the C++ core (`cat_tpu_torch/native/wfst_decoder.cpp`); and
`decode_native_nbest`, K tokens a state in C++.

The search runs on the host, as in the JAX package; the acoustic model's
forward before it runs on the card.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

NEG_INF = -1e30


def build_tlg(lexicon, word_lm, phone2id, word2id, num_classes,
              blank=0, optimize=True):
    """T ∘ min(det(L ∘ G)): the decoding graph.

    lexicon: list of (word, [phones]); word_lm: NGramLM over words;
    phone2id/word2id: symbol tables (ids > 0).
    """
    from cat_tpu_torch.fst.fst import (compose, connect, determinize_star,
                                       minimize_encoded)
    from cat_tpu_torch.fst.graph import arpa_to_fst, ctc_topo, lexicon_fst

    G = arpa_to_fst(word_lm, sym2id=word2id)
    L = lexicon_fst(lexicon, word2id, phone2id)
    LG = connect(compose(L, G))
    if optimize:
        LG = minimize_encoded(determinize_star(LG))
    T = ctc_topo(num_classes, blank)
    return connect(compose(T, LG))


@dataclass
class _Token:
    score: float
    state: int
    bp: tuple | None  # (prev_token, olabel)


def _ptr(a, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


class WfstDecoder:
    """Token-passing Viterbi beam search. Defaults: beam 17, max_active
    7000 (Kaldi's decode settings for CTC graphs)."""

    def __init__(self, fst, beam=17.0, max_active=7000,
                 acoustic_scale=1.0, lm_scale=1.0):
        self.beam = beam
        self.max_active = max_active
        self.ac_scale = acoustic_scale
        self.start = fst.start
        self.finals = dict(fst.finals)
        # arc tables by src state
        self.emit = [[] for _ in range(fst.num_states)]
        self.eps = [[] for _ in range(fst.num_states)]
        for src, dst, il, ol, w in fst.arcs:
            if il == 0:
                self.eps[src].append((dst, ol, w * lm_scale))
            else:
                self.emit[src].append((dst, il - 1, ol, w * lm_scale))
        self._native_tabs = None

    def _eps_expand(self, tokens):
        """Relax non-emitting arcs to a fixed point (at most 20 passes).
        Each pass relaxes the tokens as they stood when it began, in the
        dict's order, as in the JAX package (its ties break alike)."""
        changed = True
        iters = 0
        while changed and iters < 20:
            changed = False
            iters += 1
            for s, tok in list(tokens.items()):
                for dst, ol, w in self.eps[s]:
                    ns = tok.score + w
                    cur = tokens.get(dst)
                    if cur is None or ns > cur.score:
                        tokens[dst] = _Token(ns, dst, (tok, ol))
                        changed = True
        return tokens

    def _prune(self, tokens):
        if not tokens:
            return tokens
        best = max(t.score for t in tokens.values())
        kept = {s: t for s, t in tokens.items()
                if t.score >= best - self.beam}
        if len(kept) > self.max_active:
            ranked = sorted(kept.values(), key=lambda t: -t.score)
            kept = {t.state: t for t in ranked[: self.max_active]}
        return kept

    def native_tables(self):
        """The C core's arc tables (emitting and epsilon arcs in state
        order, final weights), built once per decoder."""
        if self._native_tabs is None:
            e_src, e_dst, e_lab, e_ol, e_w = [], [], [], [], []
            n_src, n_dst, n_ol, n_w = [], [], [], []
            for s in range(len(self.emit)):
                for dst, am, ol, w in self.emit[s]:
                    e_src.append(s)
                    e_dst.append(dst)
                    e_lab.append(am)
                    e_ol.append(ol)
                    e_w.append(w)
                for dst, ol, w in self.eps[s]:
                    n_src.append(s)
                    n_dst.append(dst)
                    n_ol.append(ol)
                    n_w.append(w)
            fw = np.full((len(self.emit),), NEG_INF, np.float32)
            for s, w in self.finals.items():
                fw[s] = w
            i32 = lambda x: np.ascontiguousarray(x, np.int32)
            f32 = lambda x: np.ascontiguousarray(x, np.float32)
            self._native_tabs = (
                i32(e_src), i32(e_dst), i32(e_lab), i32(e_ol), f32(e_w),
                i32(n_src), i32(n_dst), i32(n_ol), f32(n_w), f32(fw))
        return self._native_tabs

    def _native_args(self, log_probs, length):
        """The arguments the C entries share, and the frames (kept alive
        by the caller while the call runs)."""
        (e_src, e_dst, e_lab, e_ol, e_w, n_src, n_dst, n_ol, n_w,
         fw) = self.native_tables()
        lp = np.ascontiguousarray(np.asarray(log_probs)[: int(length)],
                                  np.float32)
        i32, f32 = ctypes.c_int32, ctypes.c_float
        args = (_ptr(e_src, i32), _ptr(e_dst, i32), _ptr(e_lab, i32),
                _ptr(e_ol, i32), _ptr(e_w, f32), len(e_src),
                _ptr(n_src, i32), _ptr(n_dst, i32), _ptr(n_ol, i32),
                _ptr(n_w, f32), len(n_src),
                len(self.emit), self.start, _ptr(fw, f32),
                _ptr(lp, f32), lp.shape[0], lp.shape[1],
                ctypes.c_float(self.beam), self.max_active,
                ctypes.c_float(self.ac_scale))
        return args, lp

    def decode_native(self, log_probs, length, max_out=1024):
        """1-best decode through the C++ core (`wfst_viterbi`), with the
        semantics of decode()[0]. Returns (score, [word_ids]), or
        (NEG_INF, []) when every token was pruned."""
        from cat_tpu_torch.native import wfst_lib

        lib = wfst_lib()
        args, _lp = self._native_args(log_probs, length)
        out_words = np.zeros((max_out,), np.int32)
        out_score = np.zeros((1,), np.float32)
        n = lib.wfst_viterbi(*args, _ptr(out_words, ctypes.c_int32),
                             max_out, _ptr(out_score, ctypes.c_float))
        if n < 0:
            return (NEG_INF, [])
        return (float(out_score[0]), [int(w) for w in out_words[:n]])

    def decode_native_nbest(self, log_probs, length, nbest=8,
                            max_out=1024):
        """N-best decode through the C++ K-token core (`wfst_nbest`), in
        the role of a lattice's n-best list for rescoring. Returns
        [(score, [word_ids])] best-first, deduplicated by word
        sequence."""
        from cat_tpu_torch.native import wfst_lib

        lib = wfst_lib()
        args, _lp = self._native_args(log_probs, length)
        out_words = np.zeros((nbest, max_out), np.int32)
        out_lens = np.zeros((nbest,), np.int32)
        out_scores = np.zeros((nbest,), np.float32)
        n = lib.wfst_nbest(*args, nbest, _ptr(out_words, ctypes.c_int32),
                           _ptr(out_lens, ctypes.c_int32),
                           _ptr(out_scores, ctypes.c_float), max_out)
        if n <= 0:
            return []
        return [(float(out_scores[k]),
                 [int(w) for w in out_words[k, : out_lens[k]]])
                for k in range(n)]

    def decode(self, log_probs, length, nbest=1):
        """log_probs: (T, V) AM outputs. Returns list of
        (score, [word_ids]) best-first."""
        lp = np.asarray(log_probs)[: int(length)]
        tokens = {self.start: _Token(0.0, self.start, None)}
        tokens = self._eps_expand(tokens)
        for t in range(lp.shape[0]):
            row = lp[t]
            nxt: dict[int, _Token] = {}
            for s, tok in tokens.items():
                for dst, am_id, ol, w in self.emit[s]:
                    ns = tok.score + w + self.ac_scale * float(row[am_id])
                    cur = nxt.get(dst)
                    if cur is None or ns > cur.score:
                        nxt[dst] = _Token(ns, dst, (tok, ol))
            nxt = self._eps_expand(nxt)
            tokens = self._prune(nxt)
            if not tokens:
                return [(NEG_INF, [])]
        # finals
        finals = []
        for s, tok in tokens.items():
            if s in self.finals:
                finals.append((tok.score + self.finals[s], tok))
        if not finals:
            finals = [(t.score, t) for t in tokens.values()]
        finals.sort(key=lambda x: -x[0])
        out = []
        for score, tok in finals[:nbest]:
            words = []
            cur = tok
            while cur.bp is not None:
                prev, ol = cur.bp
                if ol != 0:
                    words.append(ol)
                cur = prev
            out.append((score, words[::-1]))
        return out
