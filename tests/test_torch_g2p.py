"""Port parity for joint-sequence G2P: `cat_tpu_torch.fst.g2p` against
`cat_tpu.fst.g2p` on the CPU, on the JAX package's test lexicon
(`tests/test_g2p.py`) and a seeded random one: the same graphone LM
(every n-gram and backoff equal), the same predictions and n-best lists
(phones equal, log10 scores within 1e-9), and a saved model that loads
back.
"""
import numpy as np
import pytest

from cat_tpu.fst import g2p as jg2p
from cat_tpu_torch.fst import g2p as pg2p
from tests.test_g2p import LEXICON


def random_lexicon(seed, n=14):
    rng = np.random.default_rng(seed)
    letters = "abcdefg"
    sound = {c: c.upper() for c in letters}
    sound["f"] = "F"
    out = []
    for _ in range(n):
        w = "".join(letters[int(i)] for i in
                    rng.integers(0, len(letters), int(rng.integers(2, 6))))
        ph = [sound[c] for c in w]
        if len(ph) > 2 and rng.random() < 0.3:
            ph = ph[:-1]  # a silent last letter
        out.append((w, ph))
    return out


def trained(lexicon, **kw):
    return jg2p.G2P.train(lexicon, **kw), pg2p.G2P.train(lexicon, **kw)


def assert_same_predictions(got, want):
    assert [p for p, _ in got] == [p for p, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("lexicon,kw", [
    (LEXICON, dict(max_g=2, max_p=1, em_iters=6, order=3)),
    (random_lexicon(0), dict(max_g=2, max_p=2, em_iters=4, order=3)),
    (random_lexicon(1), dict(max_g=1, max_p=2, em_iters=5, order=2))])
def test_g2p_matches_jax(lexicon, kw):
    want, got = trained(lexicon, **kw)
    assert got.lm.order == want.lm.order
    for k in range(1, want.lm.order + 1):
        assert got.lm.probs[k] == want.lm.probs[k]
    for k in range(want.lm.order):
        assert got.lm.bows[k] == want.lm.bows[k]
    assert dict(got.by_g) == dict(want.by_g)
    words = [w for w, _ in lexicon] + ["phack", "cabbage", "gag"]
    for w in words:
        for nbest, beam in ((1, 16), (3, 16), (4, 2)):
            assert_same_predictions(got.predict(w, nbest=nbest, beam=beam),
                                    want.predict(w, nbest=nbest, beam=beam))


def test_graphone_and_save_load(tmp_path):
    assert pg2p.graphone(("s", "h"), ("S",)) == \
        jg2p.graphone(("s", "h"), ("S",)) == "s|h}S"
    assert pg2p.graphone(("e",), ()) == "e}_"
    _, got = trained(LEXICON, max_g=2, max_p=1, em_iters=6, order=3)
    got.save(str(tmp_path / "g2p.pkl"))
    back = pg2p.G2P.load(str(tmp_path / "g2p.pkl"))
    assert isinstance(back, pg2p.G2P)
    assert back.predict("phack", nbest=3) == got.predict("phack", nbest=3)
