"""N-gram language models (counterpart of `cat_tpu/fst/ngram.py`):
interpolated Kneser-Ney training with Good-Turing-estimated discounts, a
backoff scorer for shallow fusion and rescoring, and ARPA read/write in
the log10 convention (plain or `.gz`). A file written by either package
reads back equal in the other: log10 values to 6 decimals, n-grams
sorted by their tokens as strings.
"""
from __future__ import annotations

import gzip
import math
from collections import Counter

BOS = "<s>"
EOS = "</s>"
UNK = "<unk>"


class NGramLM:
    """Backoff n-gram LM. probs[k][(ctx..., w)] = log10 p; bows[k][ctx] =
    log10 backoff weight for a length-k context."""

    def __init__(self, order):
        self.order = order
        self.probs = [dict() for _ in range(order + 1)]  # index by ngram len
        self.bows = [dict() for _ in range(order)]       # by context len

    def logp(self, context, word):
        """log10 p(word | context) with backoff. context: tuple of tokens
        (most recent last), truncated to order-1."""
        context = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        while True:
            ng = context + (word,)
            k = len(ng)
            if ng in self.probs[k]:
                return self.probs[k][ng]
            if not context:
                return self.probs[1].get((UNK,), -99.0)
            bow = self.bows[len(context)].get(context, 0.0)
            context = context[1:]
            # accumulate backoff weight and recurse iteratively
            return bow + self.logp(context, word)

    def score_sentence(self, tokens):
        """Total log10 prob of a sentence (tokens w/o <s>/</s>)."""
        ctx = (BOS,) * (self.order - 1) if self.order > 1 else ()
        total = 0.0
        for w in list(tokens) + [EOS]:
            total += self.logp(ctx, w)
            ctx = (ctx + (w,))[-(self.order - 1):] if self.order > 1 else ()
        return total

    def perplexity(self, sentences):
        total, count = 0.0, 0
        for s in sentences:
            total += self.score_sentence(s)
            count += len(s) + 1
        return 10.0 ** (-total / max(count, 1))

    def ngrams_iter(self):
        """(k, ngram, log10 p, log10 backoff or None) of every entry."""
        for k in range(1, self.order + 1):
            for ng, lp in self.probs[k].items():
                bow = None
                if k < self.order and ng in self.bows[k]:
                    bow = self.bows[k][ng]
                yield k, ng, lp, bow


def train_ngram(sentences, order=3, vocab=None):
    """Interpolated Kneser-Ney. sentences: iterable of token lists.

    Returns an NGramLM. Tokens may be any hashable (str/int)."""
    counts = [Counter() for _ in range(order + 1)]  # counts[k]: k-grams
    for sent in sentences:
        toks = ([BOS] * max(order - 1, 1)) + list(sent) + [EOS]
        n = len(toks)
        start = max(order - 1, 1)
        for i in range(start, n):
            for k in range(1, order + 1):
                if i - k + 1 >= 0:
                    ng = tuple(toks[i - k + 1: i + 1])
                    # skip pure-BOS grams shorter than context
                    counts[k][ng] += 1

    if vocab is None:
        vocab = set(w for ng in counts[1] for w in ng)
    vocab = set(vocab) | {EOS, UNK}
    vocab.discard(BOS)

    # continuation counts for orders < top: N1+(*, ngram)
    cont = [Counter() for _ in range(order)]  # cont[k]: k-grams
    for k in range(1, order):
        for ng in counts[k + 1]:
            cont[k][ng[1:]] += 1

    # discounts via Good-Turing estimate per order
    def discount(k):
        n1 = sum(1 for c in counts[k].values() if c == 1)
        n2 = sum(1 for c in counts[k].values() if c == 2)
        if n1 == 0 or n1 + 2 * n2 == 0:
            return 0.5
        return n1 / (n1 + 2.0 * n2)

    D = [0.0] + [discount(k) for k in range(1, order + 1)]

    lm = NGramLM(order)

    # ---- unigrams from continuation counts (KN), interpolated to uniform
    V = len(vocab)
    if order == 1:
        uni_counts = counts[1]
        total = sum(uni_counts.values())
        d = D[1]
        lam = d * len(uni_counts) / max(total, 1)
        for w in vocab:
            c = uni_counts.get((w,), 0)
            p = max(c - d, 0.0) / max(total, 1) + lam / V
            if p > 0:
                lm.probs[1][(w,)] = math.log10(p)
    else:
        uni_cont = cont[1]
        total_cont = sum(uni_cont.values())
        d = D[2]
        lam = d * len(uni_cont) / max(total_cont, 1)
        for w in vocab:
            c = uni_cont.get((w,), 0)
            p = max(c - d, 0.0) / max(total_cont, 1) + lam / V
            if p > 0:
                lm.probs[1][(w,)] = math.log10(p)
    lm.probs[1][(BOS,)] = -99.0

    # ---- higher orders
    def lower_logp(ng):
        """interpolated KN log10 prob of ng's last word given shortened
        context, already stored in lm.probs."""
        for k in range(len(ng), 0, -1):
            sub = ng[-k:]
            if sub in lm.probs[k]:
                return lm.probs[k][sub]
        return -99.0

    for k in range(2, order + 1):
        d = D[k]
        # context totals and distinct-continuation counts
        ctx_tot = Counter()
        ctx_distinct = Counter()
        # for lower orders use continuation counts (KN)
        if k < order:
            kn_counts = cont[k]
        else:
            kn_counts = counts[k]
        for ng, c in kn_counts.items():
            ctx_tot[ng[:-1]] += c
            ctx_distinct[ng[:-1]] += 1
        for ng, c in kn_counts.items():
            ctx = ng[:-1]
            tot = ctx_tot[ctx]
            lam = d * ctx_distinct[ctx] / tot
            p = max(c - d, 0.0) / tot
            p_low = 10.0 ** lower_logp(ng[1:])
            p_final = p + lam * p_low
            if p_final > 0:
                lm.probs[k][ng] = math.log10(p_final)
        if k - 1 < order:
            for ctx, tot in ctx_tot.items():
                lam = d * ctx_distinct[ctx] / tot
                if lam > 0:
                    lm.bows[k - 1][ctx] = math.log10(lam)
    return lm


def _open(fileobj, mode):
    """(file object, whether to close it): a path opens, `.gz` through
    gzip."""
    if isinstance(fileobj, str):
        opener = gzip.open if fileobj.endswith(".gz") else open
        return opener(fileobj, mode), True
    return fileobj, False


def write_arpa(lm: NGramLM, fileobj):
    """ARPA text: log10 probabilities and backoffs to 6 decimals, each
    order's n-grams sorted by their tokens as strings."""
    fileobj, close = _open(fileobj, "wt")
    fileobj.write("\\data\\\n")
    for k in range(1, lm.order + 1):
        fileobj.write(f"ngram {k}={len(lm.probs[k])}\n")
    for k in range(1, lm.order + 1):
        fileobj.write(f"\n\\{k}-grams:\n")
        for ng in sorted(lm.probs[k], key=lambda x: tuple(map(str, x))):
            line = f"{lm.probs[k][ng]:.6f}\t{' '.join(map(str, ng))}"
            if k < lm.order and ng in lm.bows[k]:
                line += f"\t{lm.bows[k][ng]:.6f}"
            fileobj.write(line + "\n")
    fileobj.write("\n\\end\\\n")
    if close:
        fileobj.close()


def read_arpa(fileobj, to_int=False):
    """Read an ARPA file (tab- or space-separated). If to_int, tokens
    parse as ints where possible."""
    fileobj, close = _open(fileobj, "rt")

    def conv(tok):
        if to_int:
            try:
                return int(tok)
            except ValueError:
                return tok
        return tok

    lines = [line.rstrip("\n") for line in fileobj]
    if close:
        fileobj.close()
    order = 0
    for line in lines:
        line = line.strip()
        if line.startswith("ngram "):
            order = max(order, int(line.split()[1].split("=")[0]))
    lm = NGramLM(order)
    cur = 0
    for line in lines:
        ls = line.strip()
        if not ls:
            continue
        if ls.startswith("\\") and ls.endswith("-grams:"):
            cur = int(ls[1:].split("-")[0])
            continue
        if ls.startswith("\\"):
            cur = 0
            continue
        if cur == 0:
            continue
        if "\t" in ls:
            parts = ls.split("\t")
            lp = float(parts[0])
            toks = parts[1].split()
            bow = float(parts[2]) if len(parts) > 2 else None
        else:
            parts = ls.split()
            lp = float(parts[0])
            toks = parts[1:1 + cur]
            bow = float(parts[1 + cur]) if len(parts) > 1 + cur else None
        ng = tuple(conv(t) for t in toks)
        lm.probs[cur][ng] = lp
        if bow is not None and cur < order:
            lm.bows[cur][ng] = bow
    return lm
