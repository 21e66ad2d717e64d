"""Port parity for the n-gram LM: `cat_tpu_torch.fst.ngram` against
`cat_tpu.fst.ngram` on the CPU.

- ARPA files written by either package read back in the other as in
  itself, with the LM's log10 probabilities and backoffs within 1e-6
  (the files' 6 decimals; a backoff of a context that is no n-gram of
  its own, such as (<s>, <s>), has no line in ARPA, in either package),
  and both packages write the same text for the same LM; plain and
  `.gz`, tokens as strings and as ids (`to_int`), orders 1-4.
- `score_sentence`, `perplexity` and `ngrams_iter` give JAX's values.
"""
import io

import numpy as np
import pytest

from cat_tpu.fst import ngram as jng
from cat_tpu_torch.fst import ngram as png


def _corpus(seed, ints):
    """Seeded sentences of 1-12 tokens over a vocabulary of 9."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(9)]
    out = []
    for _ in range(60):
        ids = rng.integers(1, 10, size=int(rng.integers(1, 13)))
        out.append([int(i) for i in ids] if ints else
                   [words[i - 1] for i in ids])
    return out


def _same_lm(got, want, atol):
    assert got.order == want.order
    for k in range(1, want.order + 1):
        assert got.probs[k].keys() == want.probs[k].keys(), k
        for ng, lp in want.probs[k].items():
            assert abs(got.probs[k][ng] - lp) <= atol, (ng, k)
    for k in range(want.order):
        assert got.bows[k].keys() == want.bows[k].keys(), k
        for ng, b in want.bows[k].items():
            assert abs(got.bows[k][ng] - b) <= atol, (ng, k)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("ints", [False, True])
def test_port_trains_jax_lm_and_writes_the_same_arpa(order, ints):
    sents = _corpus(order, ints)
    want, got = jng.train_ngram(sents, order), png.train_ngram(sents, order)
    _same_lm(got, want, 0.0)
    fj, fp = io.StringIO(), io.StringIO()
    jng.write_arpa(want, fj)
    png.write_arpa(got, fp)
    assert fp.getvalue() == fj.getvalue()
    assert fp.getvalue().startswith("\\data\\\n")


@pytest.mark.parametrize("suffix", [".arpa", ".arpa.gz"])
@pytest.mark.parametrize("ints", [False, True])
@pytest.mark.parametrize("order", [2, 3])
def test_arpa_files_cross_packages(tmp_path, suffix, ints, order):
    sents = _corpus(10 + order, ints)
    lm = jng.train_ngram(sents, order)
    for writer, reader in ((jng, png), (png, jng)):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}{suffix}")
        writer.write_arpa(lm, path)
        back = reader.read_arpa(path, to_int=ints)
        # both readers read the file alike
        _same_lm(back, writer.read_arpa(path, to_int=ints), 0.0)
        for k in range(1, order + 1):
            assert back.probs[k].keys() == lm.probs[k].keys()
            for ng, lp in lm.probs[k].items():
                assert abs(back.probs[k][ng] - lp) <= 1e-6
        for k in range(order):
            assert back.bows[k].keys() == lm.bows[k].keys() & \
                lm.probs[k].keys()
            for ng, b in back.bows[k].items():
                assert abs(b - lm.bows[k][ng]) <= 1e-6
        ctx = tuple(sents[0][:order - 1])
        for w in sents[1]:
            assert abs(back.logp(ctx, w) - lm.logp(ctx, w)) <= 1e-6 * order


def test_read_arpa_space_separated_file():
    """An ARPA file separated by spaces (as other toolkits write it)."""
    text = ("\\data\\\nngram 1=3\nngram 2=2\n\n\\1-grams:\n"
            "-0.5 <s> -0.2\n-0.3 a -0.1\n-0.7 </s>\n\n\\2-grams:\n"
            "-0.1 <s> a\n-0.2 a </s>\n\n\\end\\\n")
    got = png.read_arpa(io.StringIO(text))
    want = jng.read_arpa(io.StringIO(text))
    _same_lm(got, want, 0.0)
    assert got.bows[1][("<s>",)] == -0.2 and got.probs[2][("a", "</s>")] == -0.2


@pytest.mark.parametrize("order", [1, 2, 3])
def test_scores_match_jax(order):
    sents = _corpus(20 + order, ints=False)
    want, got = jng.train_ngram(sents, order), png.train_ngram(sents, order)
    dev = _corpus(30, ints=False)[:20] + [["unseen", "w1"]]
    for s in dev:
        assert got.score_sentence(s) == want.score_sentence(s)
    assert got.perplexity(dev) == want.perplexity(dev)
    assert list(got.ngrams_iter()) == list(want.ngrams_iter())
