"""Port parity for the LM-aided decode paths of the pipeline:
`cat_tpu_torch.pipeline.asr` stage 4 against `cat_tpu.pipeline.asr` on
one JAX checkpoint of the asr-ctc and asr-rnnt templates, on the yes/no
toy data of `tests/test_torch_pipeline.py` (the same fixtures).

- decode mode "wfst" (a word 2-gram TLG built from the train
  transcripts): 1-best through `wfst_viterbi`, n-best through
  `wfst_nbest`, and the Python search (`decode.native` false) write
  JAX's decode_dev.txt, WER counts and n-best lists (texts equal,
  scores within 1e-4); the cached tlg.npz and tlg_words.txt of either
  package load in the other, and the port writes JAX's files.
- decode.lm (a token n-gram, the host prefix beam, CTC; and
  `RNNTBeamDecoder`'s fusion, RNN-T) and decode.rescore (a word n-gram
  over the n-best lists) give JAX's files; so do decode.lm "nn" (a
  neural LM of a JAX LM experiment sharing the AM's tokenizer, scored by
  `NeuralLMScorer`) and "lodr" (that LM and a token 2-gram of negative
  weight), and decode.rescore with that neural LM, for CTC here and for
  RNN-T in `tests/test_torch_lm_decode_rnnt.py`.
- den_lm.path of an .arpa builds JAX's `DenseDen` (tables within 1e-6);
  an order-4 ARPA needs the arc-table denominator and raises (§A.6).
- `python -m cat_tpu_torch.pipeline.ngram` writes JAX's ARPA file and
  dev perplexity.
"""
import json
import os
import shutil

import numpy as np
import pytest

from cat_tpu.fst import ngram as jng
from cat_tpu.pipeline import asr as jax_asr
from cat_tpu_torch.fst.fst import Fst
from cat_tpu_torch.pipeline import asr
from cat_tpu_torch.utils import tokenizer as tknz
from tests.test_torch_pipeline import (_assert_same_decode, _decode_both,
                                       _jax_checkpoint, _stage_from, staged,
                                       yesno)

assert staged and yesno  # module fixtures, shared with the pipeline tests


def _ctc_expdir(staged, tmp_path, decode, template="asr-ctc",
                family="ctc", scale=8.0):
    def edit(hyper, config):
        hyper["inference"]["decode"].update(decode)

    expdir, hyper, config, tok = _stage_from(staged, tmp_path / "exp",
                                             template, edit)
    _jax_checkpoint(expdir, config, family, tok, scale=scale)
    return expdir


@pytest.mark.parametrize("nbest,native", [(1, True), (3, True),
                                          (2, False)])
def test_wfst_stage_4_matches_jax(staged, tmp_path, nbest, native):
    dec = {"mode": "wfst", "wfst": {"order": 2, "beam": 30.0},
           "nbest": nbest, "native": native}
    expdir = _ctc_expdir(staged, tmp_path, dec)
    jax_out, port_out = _decode_both(expdir)
    _assert_same_decode(jax_out, port_out)
    assert port_out[1]["mode"] == "wfst"
    assert {len(v) for v in port_out[2].values()} <= set(range(1, nbest + 1))
    # the port loaded JAX's cached graph; the port's own build writes
    # the same files
    want = Fst.load(os.path.join(expdir, "tlg.npz"))
    with open(os.path.join(expdir, "tlg_words.txt")) as f:
        words = f.read()
    assert words == "no\nyes\n"
    for name in ("tlg.npz", "tlg_words.txt"):
        os.remove(os.path.join(expdir, name))
    asr.main([expdir, "--start_stage", "4", "--device", "cpu"])
    got = Fst.load(os.path.join(expdir, "tlg.npz"))
    assert got.arcs == want.arcs and got.finals == want.finals
    with open(os.path.join(expdir, "tlg_words.txt")) as f:
        assert f.read() == words
    with open(os.path.join(expdir, "decode_dev.txt")) as f:
        assert f.read() == port_out[0]


def test_wfst_stage_4_raises_when_the_native_core_fails(staged, tmp_path,
                                                        monkeypatch):
    """A failed build of the C++ core raises; it never falls back to the
    Python search."""
    from cat_tpu_torch import native

    def broken():
        raise RuntimeError("g++ failed to build wfst_decoder.cpp")

    monkeypatch.setattr(native, "wfst_lib", broken)
    expdir = _ctc_expdir(staged, tmp_path, {"mode": "wfst"})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        asr.main([expdir, "--start_stage", "4", "--device", "cpu"])
    assert not os.path.exists(os.path.join(expdir, "decode_dev.txt"))


@pytest.mark.parametrize("decode", [
    {"lm": {"type": "ngram", "order": 2}, "alpha": 0.5, "beta": 0.3,
     "nbest": 3, "beam_width": 4},
    {"lm": {"type": "ngram"}, "nbest": 2},
    {"mode": "beam", "nbest": 4, "rescore": {
        "alpha": 0.2, "beta": 0.5, "lm": {"type": "ngram", "order": 2}}},
    {"lm": {"type": "ngram", "order": 3}, "alpha": 0.8, "nbest": 3,
     "rescore": {"alpha": 1.0, "beta": -0.5}}])
def test_ctc_lm_stage_4_matches_jax(staged, tmp_path, decode):
    expdir = _ctc_expdir(staged, tmp_path, decode, scale=6.0)
    jax_out, port_out = _decode_both(expdir)
    _assert_same_decode(jax_out, port_out)


def test_rnnt_lm_stage_4_matches_jax(staged, tmp_path):
    dec = {"lm": {"type": "ngram", "order": 2}, "alpha": 0.6,
           "beta": 0.2, "nbest": 2,
           "rescore": {"alpha": 0.3, "lm": {"type": "ngram", "order": 2}}}
    expdir = _ctc_expdir(staged, tmp_path, dec, "asr-rnnt", "rnnt", 4.0)
    _assert_same_decode(*_decode_both(expdir))


def _lm_expdir(staged, path, config):
    """A JAX LM experiment (cat_tpu.lm.train's init_state, its output
    layer scaled by 3, saved by JAX's CheckpointManager) on the staged
    AM's tokenizer."""
    import jax

    from cat_tpu.lm import train as jax_lm_train
    from cat_tpu.utils.scheduler import build_scheduler
    from tests.test_torch_pipeline import JaxCkpt

    os.makedirs(path)
    shutil.copy(os.path.join(staged[1], "tokenizer.tknz"), path)
    hyper = {"data": {}, "train": {"bin": "cat_tpu.lm.train"},
             "tokenizer": {"type": "SimpleTokenizer",
                           "file": "tokenizer.tknz"}}
    config = dict(config, scheduler={
        "type": "SchedulerFixedStop", "kwargs": {"stop_step": 10},
        "optimizer": {"type": "Adam", "kwargs": {"lr": 1e-3}}})
    for name, obj in (("hyper-p.json", hyper), ("config.json", config)):
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f)
    tok = tknz.load(os.path.join(path, "tokenizer.tknz"))
    model = jax_lm_train.build_model(config, num_classes=tok.vocab_size)
    _, tx = build_scheduler(config["scheduler"])
    state = jax_lm_train.init_state(model, tx, jax.random.PRNGKey(9))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    for name in ("classifier", "head"):
        if name in params:
            params[name]["kernel"] = params[name]["kernel"] * 3.0
    JaxCkpt(os.path.join(path, "check")).save(
        {"state": state.replace(params=params)}, 1.0, 1, 1)
    return str(path)


LSTM_LM = {"decoder": {"type": "LSTMPredictor", "kwargs": {"hdim": 8}}}
TRANSFORMER_LM = {"decoder": {"type": "CausalTransformer", "kwargs": {
    "hdim": 16, "num_layers": 1, "num_heads": 2, "ff_dim": 16,
    "max_len": 64, "dropout_rate": 0.0}}}
NEURAL = [
    ("ctc", LSTM_LM, {"lm": {"type": "nn"}, "alpha": 0.5, "beta": 0.3,
                      "nbest": 3, "beam_width": 4}),
    ("ctc", TRANSFORMER_LM, {"lm": {"type": "lodr", "order": 2,
                                    "ngram_weight": -0.3}, "alpha": 0.6,
                             "nbest": 2}),
    ("ctc", TRANSFORMER_LM, {"mode": "beam", "nbest": 4, "rescore": {
        "alpha": 0.5, "beta": 0.2, "lm": {"type": "nn"}}}),
]
# the RNN-T cases run in tests/test_torch_lm_decode_rnnt.py (JAX's beam
# with a neural LM takes about a minute a case)
NEURAL_RNNT = [
    ("rnnt", LSTM_LM, {"lm": {"type": "nn"}, "alpha": 0.6, "beta": 0.2,
                       "nbest": 2, "rescore": {"alpha": 0.3, "lm": {
                           "type": "nn"}}}),
    ("rnnt", LSTM_LM, {"lm": {"type": "lodr", "ngram_weight": -0.2},
                       "alpha": 0.5, "nbest": 2}),
]


@pytest.mark.parametrize("family,lm_config,decode", NEURAL)
def test_neural_lm_stage_4_matches_jax(staged, tmp_path, family, lm_config,
                                       decode):
    neural_stage_4(staged, tmp_path, family, lm_config, decode)


def neural_stage_4(staged, tmp_path, family, lm_config, decode):
    """Stage 4 of both packages with decode.lm/decode.rescore pointing at
    a JAX LM experiment: the same files."""
    lm_dir = _lm_expdir(staged, tmp_path / "lm", lm_config)
    decode = json.loads(json.dumps(decode))
    for cfg in (decode.get("lm"), decode.get("rescore", {}).get("lm")):
        if cfg and cfg["type"] == "nn":
            cfg["exp"] = lm_dir
        elif cfg and cfg["type"] == "lodr":
            cfg["nn"] = {"exp": lm_dir}
    template = "asr-ctc" if family == "ctc" else "asr-rnnt"
    expdir = _ctc_expdir(staged, tmp_path, decode, template, family,
                         6.0 if family == "ctc" else 4.0)
    _assert_same_decode(*_decode_both(expdir))


def test_neural_fusion_changes_the_beam(staged, tmp_path):
    """At a large weight the neural LM moves the host prefix beam's scores
    away from the unfused beam's (the fusion is not a no-op)."""
    from cat_tpu_torch.utils.nbest import read_nbest
    lm_dir = _lm_expdir(staged, tmp_path / "lm", LSTM_LM)
    scores = []
    for alpha in (0.0, 3.0):
        expdir = _ctc_expdir(staged, tmp_path / f"a{alpha}", {
            "lm": {"type": "nn", "exp": lm_dir}, "alpha": alpha,
            "nbest": 2, "beam_width": 4}, scale=6.0)
        asr.main([expdir, "--start_stage", "4", "--device", "cpu"])
        nb = read_nbest(os.path.join(expdir, "nbest_dev.pkl"))
        scores.append(np.asarray([nb[u][0][0] for u in sorted(nb)]))
    assert np.abs(scores[1] - scores[0]).max() > 0.1


def _phone_arpa(path, order, V):
    rng = np.random.default_rng(order)
    seqs = [[int(x) for x in rng.integers(1, V, int(rng.integers(2, 9)))]
            for _ in range(60)]
    jng.write_arpa(jng.train_ngram(seqs, order), path)


@pytest.mark.parametrize("order", [2, 3])
def test_den_lm_arpa_builds_jax_dense_den(tmp_path, order):
    tok = tknz.SimpleTokenizer(list("abcdefg"), level="char")
    arpa = str(tmp_path / "den.arpa")
    _phone_arpa(arpa, order, tok.vocab_size)
    hyper = {"den_lm": {"order": order, "path": arpa}}
    for d in ("jax", "port"):
        os.makedirs(tmp_path / d)
    want = jax_asr.build_den(str(tmp_path / "jax"), hyper, tok, None)
    got = asr.build_den(str(tmp_path / "port"), hyper, tok, None)
    np.testing.assert_allclose(got.logw, np.asarray(want.logw), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.final, np.asarray(want.final), rtol=0,
                               atol=1e-6)
    assert got.logw.shape == (tok.vocab_size,) * 3


def test_den_lm_arpa_of_order_4_names_its_section(tmp_path):
    tok = tknz.SimpleTokenizer(list("abc"), level="char")
    arpa = str(tmp_path / "den.arpa")
    _phone_arpa(arpa, 4, tok.vocab_size)
    with pytest.raises(NotImplementedError, match="§A.6"):
        asr.build_den(str(tmp_path), {"den_lm": {"path": arpa}}, tok, None)


def test_ngram_pipeline_matches_jax(tmp_path, capsys):
    from cat_tpu.pipeline import ngram as jax_ngram
    from cat_tpu_torch.pipeline import ngram
    rng = np.random.default_rng(4)
    words = ["yes", "no", "maybe", "so", "then"]
    for split, n in (("train", 80), ("dev", 20)):
        (tmp_path / f"{split}.txt").write_text("".join(
            " ".join(words[int(i)] for i in rng.integers(
                0, 5, int(rng.integers(1, 7)))) + "\n" for _ in range(n)))
    outs = []
    for mod, name in ((jax_ngram, "jax"), (ngram, "port")):
        d = tmp_path / name
        d.mkdir()
        (d / "hyper-p.json").write_text(json.dumps({
            "data": {"train": str(tmp_path / "train.txt"),
                     "dev": str(tmp_path / "dev.txt")},
            "tokenizer": {"type": "SimpleTokenizer",
                          "option-init": {"level": "word"}},
            "ngram": {"order": 3}}))
        mod.main([str(d)])
        res = json.loads(capsys.readouterr().out.splitlines()[-1])
        outs.append((res, (d / "3gram.arpa").read_text(),
                     tknz.load(str(d / "tokenizer.tknz"))._i2t))
    (jres, jarpa, ji2t), (pres, parpa, pi2t) = outs
    assert parpa == jarpa and pi2t == ji2t
    assert pres["dev_ppl"] == jres["dev_ppl"] and pres["order"] == 3
    # --order overrides the recipe's
    ngram.main([str(tmp_path / "port"), "--order", "2"])
    assert os.path.exists(tmp_path / "port" / "2gram.arpa")
