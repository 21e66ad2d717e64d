"""Graph builders (counterpart of `cat_tpu/fst/graph.py`): the CTC
topology T, an ARPA n-gram as an acceptor G, the lexicon L, and the
CTC-CRF denominator graph T ∘ G.

Label conventions:
- FST ilabel = AM output index + 1; ilabel 0 is epsilon.
- olabels are phone/word symbol-table ids; 0 is epsilon.

`DenGraph` flattens an epsilon-free denominator FST into dense arc tables
(numpy), the layout of the arc-table denominator.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from cat_tpu_torch.fst.fst import (EPS, NEG_INF, Fst, compose, connect,
                                   rm_epsilon)
from cat_tpu_torch.fst.ngram import BOS, EOS, UNK, NGramLM

LN10 = math.log(10.0)


def ctc_topo(num_classes: int, blank: int = 0) -> Fst:
    """CTC topology T: input AM symbols (shifted by +1), output phone ids.

    State 0 is start/final with a blank self-loop; each non-blank symbol v
    has a state with a self-loop; transitions between symbol states emit
    the new symbol; blank returns to state 0.
    """
    fst = Fst()
    s0 = fst.add_state()
    fst.start = s0
    fst.set_final(s0, 0.0)
    fst.add_arc(s0, s0, blank + 1, EPS, 0.0)  # blank self-loop
    sym_state = {}
    symbols = [v for v in range(num_classes) if v != blank]
    for v in symbols:
        s = fst.add_state()
        sym_state[v] = s
        fst.set_final(s, 0.0)
    for v in symbols:
        s = sym_state[v]
        fst.add_arc(s0, s, v + 1, v, 0.0)   # enter from start, emit v
        fst.add_arc(s, s, v + 1, EPS, 0.0)  # repeat frames, no emission
        fst.add_arc(s, s0, blank + 1, EPS, 0.0)  # blank back to start
        for u in symbols:
            if u != v:
                fst.add_arc(s, sym_state[u], u + 1, u, 0.0)  # direct switch
    return fst


def arpa_to_fst(lm: NGramLM, sym2id=None, bos=BOS, eos=EOS) -> Fst:
    """Backoff n-gram LM → acceptor G (labels = token symbol ids).

    Standard construction: a state per context, backoff epsilon arcs to
    shortened contexts, EOS n-grams become final weights. Weights are
    natural-log probabilities.
    """
    order = lm.order
    ident = sym2id is None

    def sid(tok):
        if ident:
            return int(tok)
        return sym2id[tok]

    # context states: all ngrams of len < order that appear as prob entries
    # (they can be contexts of longer ngrams), plus the empty context.
    contexts = {()}
    for k in range(1, order):
        for ng in lm.probs[k]:
            contexts.add(ng)
    fst = Fst()
    state_of = {}
    for ctx in sorted(contexts, key=lambda c: (len(c), tuple(map(str, c)))):
        state_of[ctx] = fst.add_state()

    def ctx_state(ctx):
        """Longest suffix of ctx that is a context state."""
        ctx = tuple(ctx)
        while ctx not in state_of:
            ctx = ctx[1:]
        return state_of[ctx], ctx

    start_ctx = (bos,) * (order - 1) if order > 1 else ()
    fst.start, _ = ctx_state(start_ctx)
    if fst.start == state_of[()] and order > 1 and (bos,) in state_of:
        fst.start = state_of[(bos,)]

    for k in range(1, order + 1):
        for ng, lp in lm.probs[k].items():
            ctx, w = ng[:-1], ng[-1]
            if w == bos or w == UNK or (not ident and w not in sym2id
                                        and w != eos):
                continue
            if ctx and ctx not in state_of:
                continue  # context never materialized (unreachable)
            src = state_of[ctx] if ctx else state_of[()]
            wt = lp * LN10
            if w == eos:
                fst.set_final(src, wt)
                continue
            dst, _ = ctx_state(ng if k < order else ng[1:])
            fst.add_arc(src, dst, sid(w), sid(w), wt)
    # backoff arcs
    for k in range(1, order):
        for ctx, bow in lm.bows[k].items():
            if ctx not in state_of:
                continue
            dst, _ = ctx_state(ctx[1:])
            fst.add_arc(state_of[ctx], dst, EPS, EPS, bow * LN10)
    return connect(fst)


def lexicon_fst(lexicon, word2id, phone2id, sil_phone=None,
                sil_prob=0.0) -> Fst:
    """L: phones (input) → words (output). lexicon: list of
    (word, [phones]). Optional silence insertion between words."""
    fst = Fst()
    root = fst.add_state()
    fst.start = root
    fst.set_final(root, 0.0)
    for word, phones in lexicon:
        if not phones:
            continue
        cur = root
        for i, p in enumerate(phones):
            nxt = root if i == len(phones) - 1 else fst.add_state()
            ol = word2id[word] if i == 0 else EPS
            fst.add_arc(cur, nxt, phone2id[p], ol, 0.0)
            cur = nxt
    if sil_phone is not None and sil_prob > 0:
        w = math.log(sil_prob)
        fst.add_arc(root, root, phone2id[sil_phone], EPS, w)
    return fst


@dataclass
class DenGraph:
    """Flattened denominator graph: dense arc tables (a flat table of
    arcs with their source and destination states), as the JAX package
    saves them."""

    arc_src: np.ndarray      # (A,) int32
    arc_dst: np.ndarray      # (A,) int32
    arc_label: np.ndarray    # (A,) int32 — AM output index (ilabel - 1)
    arc_weight: np.ndarray   # (A,) float32 natural-log prob
    start_weights: np.ndarray  # (Q,) float32 (LOG_EPS if not initial)
    final_weights: np.ndarray  # (Q,) float32
    num_states: int

    @classmethod
    def from_fst(cls, fst: Fst) -> "DenGraph":
        arr, w = fst.arrays()
        if np.any(arr[:, 2] == EPS):
            raise ValueError("DenGraph requires an epsilon-free FST; "
                             "run rm_epsilon first")
        starts = np.full((fst.num_states,), NEG_INF, np.float32)
        starts[fst.start] = 0.0
        return cls(
            arc_src=arr[:, 0].astype(np.int32),
            arc_dst=arr[:, 1].astype(np.int32),
            arc_label=(arr[:, 2] - 1).astype(np.int32),
            arc_weight=w.astype(np.float32),
            start_weights=starts,
            final_weights=fst.final_array(),
            num_states=fst.num_states,
        )

    def save(self, path):
        np.savez(path, src=self.arc_src, dst=self.arc_dst,
                 label=self.arc_label, weight=self.arc_weight,
                 start=self.start_weights, final=self.final_weights,
                 num_states=np.int32(self.num_states))

    @classmethod
    def load(cls, path):
        z = np.load(path)
        return cls(arc_src=z["src"], arc_dst=z["dst"], arc_label=z["label"],
                   arc_weight=z["weight"], start_weights=z["start"],
                   final_weights=z["final"],
                   num_states=int(z["num_states"]))


def build_den_fst(phone_lm: NGramLM, num_classes: int,
                  blank: int = 0) -> Fst:
    """Denominator graph: T ∘ G(phone LM), epsilon-removed and
    trimmed."""
    T = ctc_topo(num_classes, blank)
    G = arpa_to_fst(phone_lm)
    TG = compose(T, G)
    return rm_epsilon(TG)
