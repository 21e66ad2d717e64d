"""Port parity for TLG decoding graphs and the Python WFST search:
`cat_tpu_torch.fst.decode` against `cat_tpu.fst.decode` on the CPU.

- `build_tlg` of the JAX package's toy (`tests/test_tlg.py` `build_toy`)
  and of seeded random lexicons gives the same graph arc for arc (labels
  equal, weights within 1e-6), with and without `optimize`; a `tlg.npz`
  saved by either package loads in the other.
- `WfstDecoder.decode` gives JAX's n-best (word ids equal, scores within
  1e-6) on the toy's synthetic posteriors (`am_for`) and on seeded random
  log-probs, at several beams, max_active, acoustic and LM scales.
"""
import numpy as np
import pytest

from cat_tpu.fst import decode as jdec
from cat_tpu.fst import fst as jfst
from cat_tpu.fst import ngram as jng
from cat_tpu_torch.fst import decode as pdec
from cat_tpu_torch.fst import fst as pfst
from cat_tpu_torch.fst import ngram as png
from tests.test_tlg import am_for
from tests.test_torch_fst import assert_same_fst, lexicon_and_lm

TOY_LEXICON = [("cab", ["c", "a", "b"]), ("ba", ["b", "a"]),
               ("ab", ["a", "b"])]
TOY_CORPUS = [["cab", "ba"], ["ba", "cab"], ["ab"], ["cab"], ["ba"],
              ["cab", "ab"]]
TOY_PHONES = {"a": 1, "b": 2, "c": 3}
TOY_WORDS = {"cab": 1, "ba": 2, "ab": 3}


def toy(optimize=True):
    """`tests/test_tlg.py` `build_toy` in both packages."""
    return [m.build_tlg(TOY_LEXICON, ng.train_ngram(TOY_CORPUS, order=2),
                        TOY_PHONES, TOY_WORDS, num_classes=4,
                        optimize=optimize)
            for m, ng in ((jdec, jng), (pdec, png))]


def random_tlg(seed, order):
    lexicon, corpus, word2id, phone2id = lexicon_and_lm(seed)
    return [m.build_tlg(lexicon, ng.train_ngram(corpus, order), phone2id,
                        word2id, num_classes=len(phone2id) + 1)
            for m, ng in ((jdec, jng), (pdec, png))], len(phone2id) + 1


def random_lp(seed, T, V, peak=3.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, V)) * peak
    x -= np.log(np.exp(x).sum(-1, keepdims=True))
    return x.astype(np.float32)


def assert_same_nbest(got, want):
    assert [w for _, w in got] == [w for _, w in want]
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("optimize", [True, False])
def test_toy_tlg_matches_jax(optimize):
    want, got = toy(optimize)
    assert_same_fst(got, want)


@pytest.mark.parametrize("seed,order", [(0, 2), (1, 3), (2, 3)])
def test_random_tlg_matches_jax(seed, order):
    (want, got), _ = random_tlg(seed, order)
    assert_same_fst(got, want)
    assert got.num_arcs > 100


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tlg_npz_crosses_packages(tmp_path, writer):
    want, got = toy()
    path = str(tmp_path / "tlg.npz")
    (want if writer == "jax" else got).save(path)
    assert_same_fst(pfst.Fst.load(path), jfst.Fst.load(path))
    assert_same_fst(pfst.Fst.load(path), want)


CASES = [([3, 1, 2], 0.95), ([2, 1, 3, 1, 2], 0.95), ([1, 2], 0.95),
         ([1, 2], 0.7), ([3, 1, 2, 2, 1], 0.6)]


@pytest.mark.parametrize("phones,peak", CASES)
@pytest.mark.parametrize("beam", [30.0, 4.0])
def test_python_search_matches_jax_on_the_toy(phones, peak, beam):
    want, got = toy()
    lp = am_for(phones, peak=peak)
    jd = jdec.WfstDecoder(want, beam=beam)
    pd = pdec.WfstDecoder(got, beam=beam)
    assert_same_nbest(pd.decode(lp, len(lp), nbest=4),
                      jd.decode(lp, len(lp), nbest=4))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("opts", [
    dict(beam=17.0, max_active=7000),
    dict(beam=8.0, max_active=6),
    dict(beam=12.0, max_active=40, acoustic_scale=0.7, lm_scale=1.3)])
def test_python_search_matches_jax_on_random_log_probs(seed, opts):
    (want, got), V = random_tlg(seed, 3)
    lp = random_lp(seed, 40, V)
    jd, pd = jdec.WfstDecoder(want, **opts), pdec.WfstDecoder(got, **opts)
    for length in (40, 23):
        assert_same_nbest(pd.decode(lp, length, nbest=5),
                          jd.decode(lp, length, nbest=5))


def test_python_search_on_degenerate_input():
    """No frame, and frames where every label is impossible (-inf):
    JAX's results."""
    want, got = toy()
    jd, pd = jdec.WfstDecoder(want), pdec.WfstDecoder(got)
    lp = np.full((3, 4), -np.inf, np.float32)
    for length in (0, 3):
        assert pd.decode(lp, length, nbest=2) == jd.decode(lp, length,
                                                           nbest=2)
