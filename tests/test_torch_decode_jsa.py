"""Port parity for JSA-SPG's cascade decoding (`cat_tpu_torch.ctc.
decode_jsa`) against `cat_tpu.ctc.decode_jsa`, in float32 on the CPU, on
the same weights: tests/test_torch_jsa.py's models (a 1-layer BLSTM S2P
of 16, a 1-cell `EmbeddingEncoder` P2G of d = 16; 5 phonemes, 4
graphemes, upsample 3), JAX's init perturbed, carried across by
`from_jax.jsa_state_dict`; four utterances of its batches.

- The S2P phoneme n-best (beam 4, num_z 3): the same prefixes in the same
  order, scores within 1e-4.
- `decode`, marginalised and best-path: the same grapheme hypotheses in
  the same order with scores within 1e-4, except for an utterance whose
  ranked hypotheses hold two scores within 1e-3 of each other (a near-tie
  the two packages' rounding may order either way; at most one of the
  four), which is held to the same hypotheses with the same scores in
  any order; the decoder's device and host seconds are counted.
"""
import numpy as np
import pytest
import torch

import jax

from cat_tpu.ctc import decode_jsa as jax_decode_jsa
from cat_tpu.ctc import train_jsa as jax_jsa
from cat_tpu_torch.ctc import train_jsa
from cat_tpu_torch.ctc.decode_jsa import JsaCascadeDecoder
from cat_tpu_torch.utils.from_jax import jsa_state_dict
from tests.test_torch_jsa import CFG, G, P, UP, batches
from tests.test_torch_transducer import _perturbed

torch.set_num_threads(2)
SCORE_TOL = 1e-4
TIE = 1e-3
BEAM, NUM_Z = 4, 3


@pytest.fixture(scope="module")
def decoders():
    s2p, p2g, g2p = jax_jsa.build_models(CFG, num_phonemes=P,
                                         num_graphemes=G)
    feats = np.zeros((1, 16, 6), np.float32)
    toks = np.zeros((1, 12), np.int32)
    key = jax.random.PRNGKey(0)
    params = {
        "s2p": s2p.init(key, feats, np.array([16], np.int32))["params"],
        "p2g": p2g.init(key, toks, np.array([12], np.int32))["params"],
        "g2p": g2p.init(key, toks, np.array([12], np.int32))["params"]}
    params = _perturbed(jax.tree_util.tree_map(np.asarray, params), 2)
    jd = jax_decode_jsa.JsaCascadeDecoder(
        s2p, p2g, params["s2p"], params["p2g"], upsample=UP,
        s2p_beam=BEAM, p2g_beam=BEAM, num_z=NUM_Z)
    model = train_jsa.build_model(CFG, P, G, feat_dim=6, device="cpu")
    model.load_state_dict(jsa_state_dict(model, params, {}))
    pd = JsaCascadeDecoder(model.s2p, model.p2g, upsample=UP,
                           s2p_beam=BEAM, p2g_beam=BEAM, num_z=NUM_Z)
    return jd, pd


def _utts():
    _, b, _ = batches(0)
    return [(b.feats[j, :b.feat_lengths[j]], int(b.feat_lengths[j]))
            for j in range(len(b.uids))]


def _tied(nbest):
    s = [x[0] for x in nbest]
    return any(abs(a - b) < TIE for a, b in zip(s, s[1:]))


def test_s2p_nbest_matches_jax(decoders):
    jd, pd = decoders
    for feats, n in _utts():
        want = jd.decode_s2p(feats, n)
        got = pd.decode_s2p(feats, n)
        assert [list(z) for _, z in got] == [list(z) for _, z in want]
        np.testing.assert_allclose([s for s, _ in got],
                                   [s for s, _ in want], atol=SCORE_TOL)


@pytest.mark.parametrize("marginalize", [True, False])
def test_cascade_decode_matches_jax(decoders, marginalize):
    jd, pd = decoders
    t0 = dict(pd.times)
    tied = 0
    for feats, n in _utts():
        want = jd.decode(feats, n, marginalize=marginalize)
        got = pd.decode(feats, n, marginalize=marginalize)
        assert got and len(got) == len(want)
        if _tied(want):
            tied += 1
            want, got = sorted(want, key=lambda e: e[1]), \
                sorted(got, key=lambda e: e[1])
        assert [y for _, y in got] == [list(y) for _, y in want]
        np.testing.assert_allclose([s for s, _ in got],
                                   [s for s, _ in want], atol=SCORE_TOL)
    assert tied <= 1
    assert pd.times["device"] > t0["device"] and pd.times["host"] > t0["host"]
