"""Tokenizer suite: a copy of `cat_tpu/utils/tokenizer.py`, kept in the
port so that it imports nothing of the JAX package.

Counterparts of the reference toolkit's tokenizers: AbsTokenizer
(encode/decode/vocab/dump + picklable .tknz state), SimpleTokenizer,
LexiconTokenizer word->phones, BpeTokenizer (a native BPE trainer with
the '▁' word-boundary convention and id layout: 0=<s> (doubles as CTC
blank, the toolkit convention), 1=<unk>), JiebaTokenizer and friends.

A `.tknz` file pickled by `cat_tpu` names the classes of
`cat_tpu.utils.tokenizer`; `load` reads them as this module's classes.
"""
from __future__ import annotations

import pickle
from collections import Counter

SPM_SPACE = "▁"  # '▁'


class _Unpickler(pickle.Unpickler):
    """Reads the JAX package's tokenizer classes as this module's."""

    def find_class(self, module, name):
        if module == "cat_tpu.utils.tokenizer":
            module = __name__
        return super().find_class(module, name)


class AbsTokenizer:
    def encode(self, text):
        """str | list[str] → list[int] | list[list[int]]"""
        if isinstance(text, str):
            return self._encode(text)
        return [self._encode(t) for t in text]

    def decode(self, ids):
        if ids and isinstance(ids[0], (list, tuple)):
            return [self._decode(i) for i in ids]
        return self._decode(ids)

    @property
    def vocab_size(self):
        raise NotImplementedError

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path):
        with open(path, "rb") as f:
            return _Unpickler(f).load()


class SimpleTokenizer(AbsTokenizer):
    """Word- or char-level tokenizer from a fixed vocabulary."""

    def __init__(self, vocab=None, level="word", bos="<s>", unk="<unk>"):
        self.level = level
        self.bos, self.unk = bos, unk
        tokens = [bos, unk] + [t for t in (vocab or [])
                               if t not in (bos, unk)]
        self._t2i = {t: i for i, t in enumerate(tokens)}
        self._i2t = tokens

    @classmethod
    def from_corpus(cls, lines, level="word", max_size=None):
        cnt = Counter()
        for line in lines:
            toks = line.split() if level == "word" else list(
                line.replace(" ", ""))
            cnt.update(toks)
        vocab = [t for t, _ in cnt.most_common(max_size)]
        return cls(vocab, level)

    @property
    def vocab_size(self):
        return len(self._i2t)

    def _encode(self, text):
        toks = text.split() if self.level == "word" else list(
            text.replace(" ", ""))
        unk = self._t2i[self.unk]
        return [self._t2i.get(t, unk) for t in toks]

    def _decode(self, ids):
        toks = [self._i2t[i] for i in ids if 0 <= i < len(self._i2t)]
        sep = " " if self.level == "word" else ""
        return sep.join(t for t in toks if t not in (self.bos,))


class LexiconTokenizer(AbsTokenizer):
    """Word → phone-sequence tokenizer (tokenizer.py:311-430). The vocab
    is the phone set; word-level text maps through the lexicon."""

    def __init__(self, lexicon, bos="<s>", unk="<unk>", unk_phones=None):
        self.bos, self.unk = bos, unk
        self._lexicon = {w: list(p) for w, p in lexicon.items()}
        phones = sorted({p for ps in self._lexicon.values() for p in ps})
        self._p2i = {bos: 0, unk: 1}
        for p in phones:
            if p not in self._p2i:
                self._p2i[p] = len(self._p2i)
        self._i2p = [None] * len(self._p2i)
        for p, i in self._p2i.items():
            self._i2p[i] = p
        self._unk_phones = unk_phones or []

    @property
    def vocab_size(self):
        return len(self._i2p)

    def phone_id(self, p):
        return self._p2i[p]

    def _encode(self, text):
        out = []
        for w in text.split():
            phones = self._lexicon.get(w, self._unk_phones)
            out.extend(self._p2i.get(p, 1) for p in phones)
        return out

    def _decode(self, ids):
        return " ".join(self._i2p[i] for i in ids
                        if 0 <= i < len(self._i2p) and i > 1)


class BpeTokenizer(AbsTokenizer):
    """Native BPE subword tokenizer (sentencepiece replacement).

    Words get the '▁' prefix; merges learned greedily by pair frequency.
    id 0 = <s> (CTC blank), 1 = <unk>."""

    def __init__(self, merges, vocab, bos="<s>", unk="<unk>"):
        self.bos, self.unk = bos, unk
        self.merges = merges  # list[(a, b)] in rank order
        self._rank = {pair: i for i, pair in enumerate(merges)}
        self._i2t = vocab  # [bos, unk, ...symbols]
        self._t2i = {t: i for i, t in enumerate(vocab)}

    @classmethod
    def train(cls, lines, vocab_size=1024, bos="<s>", unk="<unk>",
              character_coverage=1.0):
        word_freq = Counter()
        for line in lines:
            for w in line.split():
                word_freq[SPM_SPACE + w] += 1
        # initial symbols: characters
        words = {w: list(w) for w in word_freq}
        symbols = Counter()
        for w, f in word_freq.items():
            for ch in words[w]:
                symbols[ch] += f
        if character_coverage < 1.0:
            keep = set(t for t, _ in symbols.most_common(
                int(len(symbols) * character_coverage)))
            for w in words:
                words[w] = [c if c in keep else unk for c in words[w]]
        merges = []
        vocab = [bos, unk] + sorted(symbols)
        target_merges = max(0, vocab_size - len(vocab))
        for _ in range(target_merges):
            pairs = Counter()
            for w, f in word_freq.items():
                seq = words[w]
                for i in range(len(seq) - 1):
                    pairs[(seq[i], seq[i + 1])] += f
            if not pairs:
                break
            best, bf = pairs.most_common(1)[0]
            if bf < 2:
                break
            merges.append(best)
            new_sym = best[0] + best[1]
            vocab.append(new_sym)
            for w in words:
                seq = words[w]
                out, i = [], 0
                while i < len(seq):
                    if (i < len(seq) - 1
                            and (seq[i], seq[i + 1]) == best):
                        out.append(new_sym)
                        i += 2
                    else:
                        out.append(seq[i])
                        i += 1
                words[w] = out
        return cls(merges, vocab, bos, unk)

    @property
    def vocab_size(self):
        return len(self._i2t)

    def _bpe_word(self, word):
        seq = list(word)
        while len(seq) > 1:
            best_rank, best_i = None, -1
            for i in range(len(seq) - 1):
                r = self._rank.get((seq[i], seq[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i < 0:
                break
            seq = (seq[:best_i] + [seq[best_i] + seq[best_i + 1]]
                   + seq[best_i + 2:])
        return seq

    def _encode(self, text):
        out = []
        unk = self._t2i[self.unk]
        for w in text.split():
            for piece in self._bpe_word(SPM_SPACE + w):
                out.append(self._t2i.get(piece, unk))
        return out

    def _decode(self, ids):
        s = "".join(self._i2t[i] for i in ids
                    if 0 <= i < len(self._i2t) and i > 1)
        return s.replace(SPM_SPACE, " ").strip()


class JiebaTokenizer(AbsTokenizer):
    """Chinese word segmenter + word-level tokenizer.

    Counterpart of tokenizer.py:229-289 (JiebaTokenizer). jieba's
    HMM=False path — the only one the reference uses (tokenizer.py:275)
    — is dictionary DAG max-probability segmentation, reimplemented here
    self-contained (no jieba dependency):

    For a sentence, every dictionary word starting at each position
    forms a DAG edge; dynamic programming right-to-left maximizes
    Σ log(freq/total). Characters not covered by any word are emitted
    as single-char tokens (frequency 1, like jieba's unseen-word
    default).

    userdict: path to a "word freq" per-line file, or {word: freq}.
    """

    def __init__(self, userdict, bos_id=0, bos="<s>", unk="<unk>"):
        if isinstance(userdict, str):
            freq = {}
            with open(userdict) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    freq[parts[0]] = int(parts[1]) if len(parts) > 1 else 1
        else:
            freq = dict(userdict)
        self.freq = freq
        # jieba registers all prefixes of dict words with freq 0 so the
        # DAG builder can stop scanning early
        self._prefixes = set()
        for w in freq:
            for i in range(1, len(w)):
                self._prefixes.add(w[:i])
        self.total = max(sum(freq.values()), 1)
        self.bos, self.unk = bos, unk
        unk_id = 0 if bos_id == 1 else 1
        words = sorted(freq)
        if bos_id == -1:
            bos_id = len(words) + 1
        self._i2t = [None] * (len(words) + 2)
        self._i2t[bos_id], self._i2t[unk_id] = bos, unk
        it = iter(words)
        for i in range(len(self._i2t)):
            if self._i2t[i] is None:
                self._i2t[i] = next(it)
        self._t2i = {t: i for i, t in enumerate(self._i2t)}

    def cut(self, s):
        """Max-probability dictionary segmentation (HMM-free jieba)."""
        import math

        s = s.strip()
        n = len(s)
        if n == 0:
            return
        # DAG[i] = list of j such that s[i:j+1] is a dict word (or i
        # itself as a single char)
        dag = {}
        for i in range(n):
            ends = []
            j = i
            frag = ""
            while j < n:
                frag = frag + s[j]
                if frag in self.freq:
                    ends.append(j)
                elif frag not in self._prefixes:
                    break
                j += 1
            if not ends:
                ends = [i]
            dag[i] = ends
        logtotal = math.log(self.total)
        route = [None] * (n + 1)
        route[n] = (0.0, 0)
        for i in range(n - 1, -1, -1):
            route[i] = max(
                (math.log(self.freq.get(s[i:j + 1]) or 1) - logtotal
                 + route[j + 1][0], j)
                for j in dag[i])
        i = 0
        while i < n:
            j = route[i][1] + 1
            w = s[i:j]
            if w != " ":
                yield w
            i = j

    @property
    def vocab_size(self):
        return len(self._i2t)

    def _encode(self, text):
        unk = self._t2i[self.unk]
        return [self._t2i.get(w, unk) for w in self.cut(text)]

    def _decode(self, ids):
        return "".join(self._i2t[i] for i in ids
                       if 0 <= i < len(self._i2t)
                       and self._i2t[i] not in (self.bos, self.unk))


class JiebaComposeLexiconTokenizer(AbsTokenizer):
    """Jieba segmentation composed with word→phone mapping
    (tokenizer.py:327-430). The vocab is the phone set."""

    def __init__(self, lexicon, userdict, bos="<s>", unk="<unk>"):
        self._seg = JiebaTokenizer(userdict, bos=bos, unk=unk)
        self._w2p = LexiconTokenizer(lexicon, bos=bos, unk=unk)
        self.bos, self.unk = bos, unk

    @property
    def vocab_size(self):
        return self._w2p.vocab_size

    def _encode(self, text):
        return self._w2p._encode(" ".join(self._seg.cut(text)))

    def _decode(self, ids):
        return self._w2p._decode(ids)


class RawTokenizer(AbsTokenizer):
    """Identity over whitespace-separated integer ids
    (tokenizer.py RawTokenizer)."""

    def __init__(self, vocab_size):
        self._size = vocab_size

    @property
    def vocab_size(self):
        return self._size

    def _encode(self, text):
        return [int(t) for t in text.split()]

    def _decode(self, ids):
        return " ".join(str(i) for i in ids)


def initialize(cfg: dict) -> AbsTokenizer:
    """Factory from config: {"type": ..., "option-init": {...}} —
    mirrors tokenizer.py:673-700."""
    ttype = cfg["type"]
    opts = cfg.get("option-init", cfg.get("kwargs", {}))
    if ttype == "SimpleTokenizer":
        if "corpus" in opts:
            with open(opts["corpus"]) as f:
                return SimpleTokenizer.from_corpus(
                    f, level=opts.get("level", "word"),
                    max_size=opts.get("max_size"))
        return SimpleTokenizer(opts.get("vocab"), opts.get("level", "word"))
    if ttype == "BpeTokenizer" or ttype == "SentencePieceTokenizer":
        with open(opts["corpus"]) as f:
            return BpeTokenizer.train(
                f, vocab_size=opts.get("vocab_size", 1024))
    if ttype == "LexiconTokenizer":
        lexicon = {}
        with open(opts["lexicon"]) as f:
            for line in f:
                parts = line.split()
                if parts and parts[0] not in lexicon:
                    lexicon[parts[0]] = parts[1:]
        return LexiconTokenizer(lexicon)
    if ttype == "RawTokenizer":
        return RawTokenizer(opts["vocab_size"])
    if ttype == "JiebaTokenizer":
        return JiebaTokenizer(opts["userdict"],
                              bos_id=opts.get("bos_id", 0))
    if ttype == "JiebaComposeLexiconTokenizer":
        lexicon = {}
        with open(opts["lexicon"]) as f:
            for line in f:
                parts = line.split()
                if parts and parts[0] not in lexicon:
                    lexicon[parts[0]] = parts[1:]
        return JiebaComposeLexiconTokenizer(lexicon, opts["userdict"])
    raise ValueError(f"unknown tokenizer type {ttype}")


def save(tokenizer: AbsTokenizer, path: str):
    tokenizer.save(path)


def load(path: str) -> AbsTokenizer:
    return AbsTokenizer.load(path)
