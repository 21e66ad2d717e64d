"""Port parity for scoring: `cat_tpu_torch.utils.wer` (edit distance, WER
and CER, oracle WER) and `cat_tpu_torch.utils.nbest` (pickle IO, text to
n-best and back, interpolation) against `cat_tpu.utils.{wer,nbest}`, on
seeded and hypothesis-drawn inputs. Everything is integer counts or the
same float arithmetic in the same order: results must be equal.
"""
import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from cat_tpu.utils import nbest as jax_nbest
from cat_tpu.utils import wer as jax_wer
from cat_tpu_torch.utils import nbest, wer

WORDS = st.lists(st.sampled_from(["a", "b", "c", "dd", "e"]), max_size=9)
SENT = WORDS.map(" ".join)


@settings(max_examples=200, deadline=None)
@given(WORDS, WORDS)
def test_edit_distance_equals_jax(ref, hyp):
    got = wer.edit_distance(ref, hyp)
    assert got == jax_wer.edit_distance(ref, hyp)
    e, s, i, d = got
    assert e == s + i + d and e <= max(len(ref), len(hyp))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(SENT, SENT), max_size=6), st.booleans())
def test_wer_equals_jax(pairs, char_level):
    refs = [r for r, _ in pairs]
    hyps = [h for _, h in pairs]
    assert wer.wer(refs, hyps, char_level) == \
        jax_wer.wer(refs, hyps, char_level)


def _seeded_sets(seed, n=12):
    rng = np.random.default_rng(seed)
    vocab = ["yes", "no", "maybe", "x"]

    def sent():
        return " ".join(rng.choice(vocab, int(rng.integers(0, 7))))

    refs = {f"u{i:02d}": sent() for i in range(n)}
    hyps = {u: sent() for u in list(refs)[: n - 2]}  # two missing
    nb = {u: {k: (float(rng.normal()), sent()) for k in range(3)}
          for u in list(refs)[1:]}
    nb[list(refs)[2]] = {k: sent() for k in range(2)}  # plain strings
    return refs, hyps, nb


def test_wer_and_oracle_on_dicts_equal_jax():
    for seed in range(4):
        refs, hyps, nb = _seeded_sets(seed)
        for char_level in (False, True):
            assert wer.wer(refs, hyps, char_level) == \
                jax_wer.wer(refs, hyps, char_level)
            assert wer.oracle_wer(refs, nb, char_level) == \
                jax_wer.oracle_wer(refs, nb, char_level)


def test_nbest_io_and_interpolation_equal_jax(tmp_path):
    _, _, nb = _seeded_sets(7)
    nb = {u: v for u, v in nb.items() if isinstance(v[0], tuple)}
    nbest.write_nbest(nb, str(tmp_path / "port.pkl"))
    jax_nbest.write_nbest(nb, str(tmp_path / "jax.pkl"))
    assert (tmp_path / "port.pkl").read_bytes() == \
        (tmp_path / "jax.pkl").read_bytes()
    assert nbest.read_nbest(str(tmp_path / "jax.pkl")) == nb
    nbest.nbest_to_text(nb, str(tmp_path / "port.txt"))
    jax_nbest.nbest_to_text(nb, str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()
    assert nbest.text_to_nbest(str(tmp_path / "port.txt")) == \
        jax_nbest.text_to_nbest(str(tmp_path / "port.txt"))
    _, _, nb2 = _seeded_sets(8)
    nb2 = {u: v for u, v in nb2.items() if isinstance(v[0], tuple)}
    for weights in ([1.0, 0.0], [0.3, 0.7], [1.0, -0.5]):
        assert nbest.interpolate_nbests([nb, nb2], weights) == \
            jax_nbest.interpolate_nbests([nb, nb2], weights)


@settings(max_examples=40, deadline=None)
@given(st.dictionaries(st.sampled_from(["u1", "u2", "u3"]),
                       st.dictionaries(st.integers(0, 3),
                                       st.tuples(st.floats(-50, 5),
                                                 SENT), min_size=1),
                       min_size=1),
       st.floats(-2, 2))
def test_interpolation_of_drawn_lists_equals_jax(nb, w):
    assert nbest.interpolate_nbests([nb, nb], [1.0, w]) == \
        jax_nbest.interpolate_nbests([nb, nb], [1.0, w])
