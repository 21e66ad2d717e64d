"""Port parity for RNN-T decoding, in float32 on the CPU.

- `make_greedy_decoder`: tokens and counts equal to `cat_tpu`'s
  `make_greedy_decoder` on a ragged batch.
- `RNNTBeamDecoder`: the n-best prefixes equal to `cat_tpu`'s, scores to
  1e-4 relative, without fusion, with an `NGramLM` (alpha, beta) and
  with internal-LM subtraction.
- The decode CLI (`python -m cat_tpu_torch.rnnt.decode`), greedy and
  beam, on a `cat_tpu.rnnt.train` experiment written by the test, against
  `cat_tpu`'s decoders on the same checkpoint; `--mode streaming` on it
  (not a unified transducer) raises.
The model: a 2-cell, d=64 conformer, a 2-layer LSTM predictor and an
"add" joiner over V=12, random weights.
"""
import json
import os
import pickle
import numpy as np
import optax
import pytest
import torch

import jax

from cat_tpu.fst.ngram import train_ngram as jax_train_ngram
from cat_tpu.rnnt import decode as jax_decode
from cat_tpu.rnnt import train as jax_train
from cat_tpu.utils.checkpoint import CheckpointManager
from cat_tpu.utils.data import pack_speech_data
from cat_tpu.utils.manager import TrainState
from cat_tpu.utils.tokenizer import SimpleTokenizer
from cat_tpu_torch.fst.ngram import train_ngram
from cat_tpu_torch.rnnt import decode, train
from cat_tpu_torch.utils.from_jax import transducer_state_dict
from tests.test_torch_transducer import jax_variables

torch.set_num_threads(2)
V = 12
CFG = {"encoder": {"type": "ConformerNet",
                   "kwargs": dict(num_cells=2, hdim=64, num_heads=4,
                                  kernel_size=7, dropout_rate=0.0,
                                  scan_layers=True)},
       "predictor": {"type": "LSTMPredictor",
                     "kwargs": {"hdim": 32, "num_layers": 2}},
       "joiner": {"type": "JointNet",
                  "kwargs": {"hdim": 32, "join_mode": "add"}}}
FRAMES = (60, 47, 33)


def _feats(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((len(FRAMES), max(FRAMES), 80))
    feats *= np.arange(max(FRAMES))[None, :, None] < np.array(
        FRAMES)[:, None, None]
    return feats.astype(np.float32), np.array(FRAMES, np.int32)


@pytest.fixture(scope="module")
def models():
    """(JAX model, its variables, the port's model with the same
    weights)."""
    model = jax_train.build_model(CFG, V)
    params, stats = jax_variables(model, 0)
    # a sharper output layer, its blank bias raised: the searches then
    # both emit and skip (21, 12 and 3 greedy tokens on `_feats(2)`)
    params["joiner"]["fc_out"]["kernel"] *= 1.5
    params["joiner"]["fc_out"]["bias"][0] += 2.8
    variables = {"params": params, "batch_stats": stats}
    port = train.build_model(CFG, V, device="cpu")
    port.load_state_dict(transducer_state_dict(params, stats))
    return model, variables, port


def test_greedy_matches_jax(models):
    model, variables, port = models
    feats, flens = _feats(2)
    want_t, want_c = jax_decode.make_greedy_decoder(
        model, max_symbols=3, max_out=40)(variables, feats, flens)
    got_t, got_c = decode.make_greedy_decoder(port, max_symbols=3,
                                              max_out=40)(feats, flens)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert 0 < got_c.min() and got_c.max() < 40


SEQS = [[1, 2, 3], [2, 3, 4, 5], [1, 3], [6, 7, 1, 2], [9, 10, 11]]


@pytest.mark.parametrize("fusion", ["none", "ngram", "ilm"])
def test_beam_matches_jax(models, fusion):
    model, variables, port = models
    feats, flens = _feats(3)
    kw = dict(beam_width=4, beta=0.3)
    jax_kw, port_kw = dict(kw), dict(kw)
    if fusion == "ngram":
        jax_kw.update(lm=jax_train_ngram(SEQS, order=2), alpha=0.5)
        port_kw.update(lm=train_ngram(SEQS, order=2), alpha=0.5)
    elif fusion == "ilm":
        jax_kw["ilm_weight"] = port_kw["ilm_weight"] = 0.4
    want = jax_decode.RNNTBeamDecoder(model, variables, **jax_kw).decode(
        feats, flens, nbest=3)
    got = decode.RNNTBeamDecoder(port, **port_kw).decode(feats, flens,
                                                         nbest=3)
    assert [[p for _, p in n] for n in got] == [[p for _, p in n]
                                                for n in want]
    np.testing.assert_allclose([[s for s, _ in n] for n in got],
                               [[s for s, _ in n] for n in want], rtol=1e-4)
    assert any(len(n[0][1]) for n in got)


def _expdir(root, variables):
    """A tiny RNN-T experiment written with cat_tpu's own helpers."""
    tok = SimpleTokenizer(list("abcdefghij"), level="char")
    assert tok.vocab_size == V
    tok.save(os.path.join(root, "tokenizer.tknz"))
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(CFG, f)
    with open(os.path.join(root, "hyper-p.json"), "w") as f:
        json.dump({"tokenizer": {"file": "tokenizer.tknz"},
                   "train": {"bin": "cat_tpu.rnnt.train"}}, f)
    feats, flens = _feats(4)
    utts = [(f"utt{i}", feats[i, :n], [2, 3]) for i, n in enumerate(flens)]
    pack_speech_data(os.path.join(root, "pkl", "dev"), utts)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]),
                       step=np.asarray(0))
    CheckpointManager(os.path.join(root, "check")).save(
        {"state": state}, 1.0, 0, 0)
    return tok, utts


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_decode_cli_matches_jax(tmp_path, models, mode):
    model, variables, _ = models
    tok, utts = _expdir(str(tmp_path), variables)
    out = tmp_path / "port.txt"
    decode.main([str(tmp_path), "--mode", mode, "--beam-width", "4",
                 "--nbest", "2", "--output", str(out), "--device", "cpu"])
    with open(str(out) + ".nbest.pkl", "rb") as f:
        nbest = pickle.load(f)
    if mode == "greedy":
        greedy = jax_decode.make_greedy_decoder(model)
    else:
        beam = jax_decode.RNNTBeamDecoder(model, variables, beam_width=4)
    lines = []
    for uid, f, _ in utts:
        if mode == "greedy":
            t, c = greedy(variables, f[None], np.array([len(f)]))
            want = [(0.0, list(np.asarray(t)[0, :int(c[0])]))]
        else:
            want = beam.decode(f[None], np.array([len(f)]), nbest=2)[0]
        lines.append(f"{uid}\t{tok.decode(want[0][1])}\n")
        assert [h for _, h in nbest[uid].values()] == [
            tok.decode(p) for _, p in want]
        np.testing.assert_allclose([s for s, _ in nbest[uid].values()],
                                   [s for s, _ in want], rtol=1e-4)
    assert out.read_text() == "".join(sorted(lines))


def test_decode_cli_refuses_unported_options(tmp_path, models):
    """`--mode streaming` decodes a unified transducer
    (`test_torch_rnnt_unified.py`); on this `cat_tpu.rnnt.train`
    experiment it raises ValueError before decoding anything."""
    _, variables, _ = models
    _expdir(str(tmp_path), variables)
    with pytest.raises(ValueError, match="unified transducer"):
        decode.main([str(tmp_path), "--device", "cpu", "--mode",
                     "streaming"])
    assert not os.path.exists(tmp_path / "decode_dev.txt")


@pytest.mark.parametrize("gz", [False, True])
def test_decode_cli_with_an_arpa_lm_matches_jax(tmp_path, models, gz):
    """`--lm` reads a token ARPA file (ids) into the beam: the n-best of
    JAX's `RNNTBeamDecoder` with the same LM read by the JAX package."""
    from cat_tpu.fst.ngram import read_arpa, write_arpa
    model, variables, _ = models
    tok, utts = _expdir(str(tmp_path), variables)
    arpa = str(tmp_path / ("lm.arpa.gz" if gz else "lm.arpa"))
    write_arpa(jax_train_ngram(SEQS, order=3), arpa)
    out = tmp_path / "port.txt"
    decode.main([str(tmp_path), "--beam-width", "4", "--nbest", "2",
                 "--lm", arpa, "--alpha", "0.8", "--beta", "0.2",
                 "--output", str(out), "--device", "cpu"])
    with open(str(out) + ".nbest.pkl", "rb") as f:
        nbest = pickle.load(f)
    beam = jax_decode.RNNTBeamDecoder(model, variables, beam_width=4,
                                      lm=read_arpa(arpa, to_int=True),
                                      alpha=0.8, beta=0.2)
    lines = []
    for uid, f, _ in utts:
        want = beam.decode(f[None], np.array([len(f)]), nbest=2)[0]
        lines.append(f"{uid}\t{tok.decode(want[0][1])}\n")
        assert [h for _, h in nbest[uid].values()] == [
            tok.decode(p) for _, p in want]
        np.testing.assert_allclose([s for s, _ in nbest[uid].values()],
                                   [s for s, _ in want], rtol=1e-4)
    assert out.read_text() == "".join(sorted(lines))
