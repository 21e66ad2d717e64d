"""Port parity for the experiment pipeline: `cat_tpu_torch.pipeline.asr`
against `cat_tpu.pipeline.asr` on the CPU, on the yes/no toy data that
the JAX package's pipeline tests draw (seed 0: 64 train and 20 dev
utterances of 1-3 words, 8 kHz tones).

- Stages 1-2 of both packages: the same vocabulary, uids and labels;
  features (fbank + CMVN) within |Δ| <= 1e-3 + 1e-4·|x|.
- `build_den`: den_dense.npz tables within 1e-6 of JAX's.
- Stage 4 on one JAX checkpoint (written by the JAX package's own
  `CheckpointManager` from `init_state`, the classifier scaled so that
  most hypotheses are not empty): CTC "beam" and "greedy" on the asr-ctc
  template, RNN-T on the asr-rnnt template give identical decode_dev.txt
  files and equal sub/ins/del counts; n-best texts equal and scores
  within 1e-4; the train-time dev WER (`eval_wer`) equal for CTC greedy,
  CTC beam 4 and RNN-T greedy.
- The port's four stages end to end on the CPU (asr-ctc, 2 epochs).
- Training from shards (`write_shards`, 16 utterances a shard, after
  stage 1): asr-ctc-crf's stages 2-3 for one epoch; only dev is packed,
  and the denominator of the label-only pass over the shards,
  den_dense.npz, is JAX's `build_den(..., shard_pattern=...)` within 1e-6.
- The five recipes of the JoinAP, TDNN and sharded slice and the two
  CUSIDE recipes (aishell rnnt-cuside, template asr-rnnt-cuside) pass
  `check_train` and `check_decode` on their own files, and their models
  build on the CPU at the recipes' widths (P drawn from a seed, as
  `tests/test_recipes.py` draws it).
- CUSIDE: stage 4 in mode "streaming" on a JAX unified checkpoint (the
  asr-rnnt-cuside template's transducer, its chunked encoding under the
  beam; a unified CTC model's `chunk_infer`, greedy at beam 1 and the
  device beam at beam 4) equal to JAX's, as above; a model that is not
  unified decodes "streaming" offline, as in JAX; the four stages of the
  asr-rnnt-cuside template (bin `cat_tpu.rnnt.train_unified`) and of a
  unified CTC experiment (bin `cat_tpu_torch.ctc.train_unified`) for one
  epoch each.
- Every path not ported raises NotImplementedError naming its ROADMAP.md
  section; the streaming paths that raised before pass the checks; one
  map of train bins, both packages' spellings of the unified bins too,
  serves the pipeline and both decode CLIs.
- Slow only: the asr-ctc template trained to its end, and the asr-rnnt
  template with the JAX package's converging toy transducer, each to at
  most 2 dev word errors (absolute counts); the asr-ctc template trained
  from shards to `tests/test_pipeline.py`'s WER gate (below 5 %: at most 1
  error in the 37 dev words); the asr-rnnt-cuside template to its end,
  streaming and offline WERs finite.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

from cat_tpu.pipeline import asr as jax_asr
from cat_tpu.utils.audio import write_wav
from cat_tpu.utils.checkpoint import CheckpointManager as JaxCkpt
from cat_tpu.utils.data import SpeechDataset
from cat_tpu.utils import tokenizer as jax_tknz
from cat_tpu_torch.pipeline import asr, tasks
from cat_tpu_torch.utils import tokenizer as tknz
from cat_tpu_torch.utils.data_sharded import write_shards

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def yesno(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "egs", "template", "local"))
    import make_data

    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("yesno")
    for split, n in (("train", 64), ("dev", 20)):
        d = root / split
        (d / "wav").mkdir(parents=True)
        scp, text = [], []
        for i in range(n):
            words = list(rng.choice(["yes", "no"],
                                    size=int(rng.integers(1, 4))))
            uid = f"{split}_{i:03d}"
            path = d / "wav" / (uid + ".wav")
            write_wav(str(path), make_data.make_utt(rng, words),
                      make_data.SR)
            scp.append(f"{uid} {path}")
            text.append(f"{uid} {' '.join(words)}")
        (d / "wav.scp").write_text("\n".join(scp) + "\n")
        (d / "text").write_text("\n".join(text) + "\n")
    return root


def _expdir(path, data, template, edit=None):
    """egs/template/exp/<template>'s JSON files, the data paths set."""
    src = os.path.join(REPO, "egs", "template", "exp", template)
    with open(os.path.join(src, "hyper-p.json")) as f:
        hyper = json.load(f)
    with open(os.path.join(src, "config.json")) as f:
        config = json.load(f)
    hyper["data"] = {"train": str(data / "train"), "dev": str(data / "dev")}
    if edit:
        edit(hyper, config)
    os.makedirs(path)
    for name, obj in (("hyper-p.json", hyper), ("config.json", config)):
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f)
    return str(path), hyper, config


@pytest.fixture(scope="module")
def staged(yesno, tmp_path_factory):
    """Stages 1-2 of both packages on the asr-ctc template."""
    root = tmp_path_factory.mktemp("staged")
    ej, hyper, config = _expdir(root / "jax", yesno, "asr-ctc")
    ep, _, _ = _expdir(root / "port", yesno, "asr-ctc")
    jax_asr.main([ej, "--stop_stage", "2"])
    asr.main([ep, "--stop_stage", "2", "--device", "cpu"])
    return ej, ep, hyper, config


def test_stages_1_2_match_jax(staged):
    ej, ep, _, _ = staged
    tj = tknz.load(os.path.join(ej, "tokenizer.tknz"))
    tp = tknz.load(os.path.join(ep, "tokenizer.tknz"))
    assert tp._i2t == tj._i2t and tp.vocab_size == 4
    worst = 0.0
    for split in ("train", "dev"):
        want = SpeechDataset(os.path.join(ej, "pkl", split))
        got = SpeechDataset(os.path.join(ep, "pkl", split))
        assert got.uids == want.uids and len(got) == {"train": 64,
                                                      "dev": 20}[split]
        for i in range(len(want)):
            (gf, gl), (wf, wl) = got[i], want[i]
            np.testing.assert_array_equal(gl, wl)
            assert gf.shape == wf.shape
            err = np.abs(gf - wf)
            assert (err <= ATOL + RTOL * np.abs(wf)).all(), err.max()
            worst = max(worst, float(err.max()))
    print(f"packed features max abs err {worst:.3g}")


@pytest.mark.parametrize("order", [2, 3])
def test_build_den_matches_jax(yesno, tmp_path, order):
    """The dense denominator of char units (V = 7) over the train
    transcripts, written to den_dense.npz by both packages."""
    text = [line.split(None, 1)[1] for line in
            (yesno / "train" / "text").read_text().splitlines()]
    tok = tknz.SimpleTokenizer.from_corpus(text, level="char")
    labels = [(None, np.asarray(tok.encode(t), np.int32)) for t in text]
    hyper = {"den_lm": {"order": order}}
    for d in ("jax", "port"):
        os.makedirs(tmp_path / d)
    jax_asr.build_den(str(tmp_path / "jax"), hyper, tok, labels)
    den = asr.build_den(str(tmp_path / "port"), hyper, tok, labels)
    want = np.load(tmp_path / "jax" / "den_dense.npz")
    got = np.load(tmp_path / "port" / "den_dense.npz")
    assert tok.vocab_size == 7 and got["logw"].shape == (7, 7, 7)
    for k in ("logw", "final"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    # the cache is read back
    again = asr.build_den(str(tmp_path / "port"), hyper, tok, None)
    np.testing.assert_array_equal(again.logw, den.logw)


def _jax_checkpoint(expdir, config, family, tok, scale, module="train"):
    """One checkpoint of the JAX package's own CheckpointManager, from
    init_state of cat_tpu.<family>.<module>, its output layer scaled by
    `scale` (a LogAdd joiner's encoder projection)."""
    import importlib

    from cat_tpu.utils.scheduler import build_scheduler
    task = importlib.import_module(f"cat_tpu.{family}.{module}")
    model = task.build_model(config, num_classes=tok.vocab_size)
    _, tx = build_scheduler(config["scheduler"])
    state = task.init_state(model, tx, 40)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    if family == "ctc":
        head = params.get("encoder", params)["classifier"]
        head["kernel"] = head["kernel"] * scale
    else:
        out = params["joiner"].get("fc_out", params["joiner"].get("fc_enc"))
        out["kernel"] = out["kernel"] * scale
    state = state.replace(params=params)
    JaxCkpt(os.path.join(expdir, "check")).save({"state": state}, 1.0, 1, 1)
    return model, state


def _decode_both(expdir):
    """Stage 4 of JAX, then of the port, in one expdir: (JAX's and the
    port's decode_dev.txt, wer_dev.json and nbest_dev.pkl)."""
    from cat_tpu_torch.utils.nbest import read_nbest
    out = []
    for run in (lambda: jax_asr.main([expdir, "--start_stage", "4"]),
                lambda: asr.main([expdir, "--start_stage", "4",
                                  "--device", "cpu"])):
        run()
        with open(os.path.join(expdir, "decode_dev.txt")) as f:
            text = f.read()
        with open(os.path.join(expdir, "wer_dev.json")) as f:
            res = json.load(f)
        out.append((text, res, read_nbest(os.path.join(expdir,
                                                       "nbest_dev.pkl"))))
        for name in ("decode_dev.txt", "wer_dev.json", "nbest_dev.pkl"):
            os.remove(os.path.join(expdir, name))
    return out


def _stage_from(staged, path, template, edit):
    """An expdir on the port's packed data and tokenizer."""
    _, ep, _, _ = staged
    yesno = os.path.dirname(json.load(open(os.path.join(
        ep, "hyper-p.json")))["data"]["dev"])
    import pathlib
    expdir, hyper, config = _expdir(path, pathlib.Path(yesno), template,
                                    edit)
    shutil.copytree(os.path.join(ep, "pkl"), os.path.join(expdir, "pkl"))
    shutil.copy(os.path.join(ep, "tokenizer.tknz"), expdir)
    return expdir, hyper, config, tknz.load(os.path.join(expdir,
                                                         "tokenizer.tknz"))


def _assert_same_decode(jax_out, port_out, n_dev=20):
    (tj, rj, nj), (tp, rp, np_) = jax_out, port_out
    assert tp == tj
    lines = tp.splitlines()
    assert len(lines) == n_dev
    non_empty = sum(bool(line.split("\t")[1].strip()) for line in lines)
    assert non_empty >= n_dev // 2, tp
    for k in ("sub", "ins", "del", "errors", "num_words"):
        assert rp[k] == rj[k], k
    assert rp["mode"] == rj["mode"] and rp["rtf"] > 0
    assert nj.keys() == np_.keys()
    for uid in nj:
        assert [t for _, t in np_[uid].values()] == \
            [t for _, t in nj[uid].values()]
        np.testing.assert_allclose([s for s, _ in np_[uid].values()],
                                   [s for s, _ in nj[uid].values()],
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_ctc_stage_4_on_a_jax_checkpoint_matches_jax(staged, tmp_path, mode):
    def edit(hyper, config):
        hyper["inference"]["decode"].update(mode=mode, nbest=3)

    expdir, hyper, config, tok = _stage_from(staged, tmp_path / "exp",
                                             "asr-ctc", edit)
    _jax_checkpoint(expdir, config, "ctc", tok, scale=8.0)
    _assert_same_decode(*_decode_both(expdir))


def test_rnnt_stage_4_on_a_jax_checkpoint_matches_jax(staged, tmp_path):
    def edit(hyper, config):
        hyper["inference"]["decode"].update(nbest=2)

    expdir, hyper, config, tok = _stage_from(staged, tmp_path / "exp",
                                             "asr-rnnt", edit)
    _jax_checkpoint(expdir, config, "rnnt", tok, scale=4.0)
    _assert_same_decode(*_decode_both(expdir))


UNIFIED = {"chunk": 32, "left_context": 32, "right_context": 8,
           "feat_dim": 40, "simu_hidden": 16}


def _unified_ctc(mode, beam):
    """The asr-ctc template as a CUSIDE CTC experiment."""
    def edit(hyper, config):
        hyper["train"]["bin"] = "cat_tpu.ctc.train_unified"
        hyper["inference"]["decode"].update(mode=mode, beam_width=beam,
                                            nbest=min(beam, 3))
        config["unified"] = dict(UNIFIED)

    return edit


def test_rnnt_streaming_stage_4_on_a_jax_checkpoint_matches_jax(staged,
                                                                tmp_path):
    def edit(hyper, config):
        hyper["inference"]["decode"].update(nbest=2)

    expdir, hyper, config, tok = _stage_from(staged, tmp_path / "exp",
                                             "asr-rnnt-cuside", edit)
    assert hyper["inference"]["decode"]["mode"] == "streaming"
    _jax_checkpoint(expdir, config, "rnnt", tok, 3.0, "train_unified")
    _assert_same_decode(*_decode_both(expdir))


@pytest.mark.parametrize("mode,beam", [("streaming", 1), ("streaming", 4),
                                       ("greedy", 4)])
def test_ctc_unified_stage_4_on_a_jax_checkpoint_matches_jax(
        staged, tmp_path, mode, beam):
    expdir, hyper, config, tok = _stage_from(staged, tmp_path / "exp",
                                             "asr-ctc", _unified_ctc(mode,
                                                                     beam))
    _jax_checkpoint(expdir, config, "ctc", tok, 8.0, "train_unified")
    _assert_same_decode(*_decode_both(expdir))


def test_streaming_mode_of_a_model_not_unified_decodes_offline(staged,
                                                               tmp_path):
    def edit(hyper, config):
        hyper["inference"]["decode"].update(mode="streaming", nbest=3)

    expdir, hyper, config, tok = _stage_from(staged, tmp_path / "exp",
                                             "asr-ctc", edit)
    _jax_checkpoint(expdir, config, "ctc", tok, scale=8.0)
    jax_out, port_out = _decode_both(expdir)
    _assert_same_decode(jax_out, port_out)
    assert port_out[1]["mode"] == "streaming"


@pytest.mark.parametrize("template,bin_", [
    ("asr-rnnt-cuside", "cat_tpu.rnnt.train_unified"),
    ("asr-ctc", "cat_tpu_torch.ctc.train_unified")])
def test_unified_four_stages_on_the_cpu(yesno, tmp_path, template, bin_):
    def edit(hyper, config):
        if template == "asr-ctc":
            _unified_ctc("streaming", 2)(hyper, config)
        hyper["train"]["bin"] = bin_
        hyper["train"]["option"]["max_epochs"] = 1

    expdir, _, _ = _expdir(tmp_path / "exp", yesno, template, edit)
    asr.main([expdir, "--device", "cpu"])
    with open(os.path.join(expdir, "wer_dev.json")) as f:
        res = json.load(f)
    assert res["mode"] == "streaming" and res["num_words"] == 37
    assert res["rtf"] > 0 and np.isfinite(res["wer"])
    with open(os.path.join(expdir, "check", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert any("dev_loss" in r and np.isfinite(r["dev_loss"]) for r in rows)
    with open(os.path.join(expdir, "decode_dev.txt")) as f:
        assert len(f.read().splitlines()) == 20


@pytest.mark.parametrize("template,beam", [("asr-ctc", 1), ("asr-ctc", 4),
                                           ("asr-rnnt", 1)])
def test_eval_metric_matches_jax(staged, tmp_path, template, beam):
    from cat_tpu_torch.utils.checkpoint import model_weights
    from cat_tpu_torch.utils.data import SpeechDataset as PortDataset
    expdir, hyper, config, tok = _stage_from(staged, tmp_path / "exp",
                                             template, None)
    family = "rnnt" if template == "asr-rnnt" else "ctc"
    jmodel, jstate = _jax_checkpoint(expdir, config, family, tok, 6.0)
    opts = dict(hyper["train"]["option"], eval_wer={"beam_width": beam})
    dev = os.path.join(expdir, "pkl", "dev")
    want = jax_asr._make_eval_metric(hyper, config, jmodel, tok,
                                     SpeechDataset(dev), opts)(jstate)
    task = tasks.train_module(hyper["train"]["bin"])
    model = task.build_model(asr._with_feat_dim(config, 40),
                             tok.vocab_size, device="cpu")
    ck = os.path.join(expdir, "check")
    model.load_state_dict(model_weights(model, os.path.join(
        ck, JaxCkpt(ck).best())))
    got = asr._make_eval_metric(hyper, model, tok, PortDataset(dev),
                                opts)(None)
    assert got == want and 0.0 < got


def test_four_stages_end_to_end_on_the_cpu(yesno, tmp_path):
    def edit(hyper, config):
        hyper["train"]["option"]["max_epochs"] = 2

    expdir, _, _ = _expdir(tmp_path / "exp", yesno, "asr-ctc", edit)
    asr.main([expdir, "--device", "cpu"])
    for name in ("tokenizer.tknz", "pkl/train/meta.npz", "pkl/dev/meta.npz",
                 "check/checkpoint.list", "check/metrics.jsonl",
                 "readme.md", "decode_dev.txt", "nbest_dev.pkl",
                 "wer_dev.json"):
        assert os.path.exists(os.path.join(expdir, name)), name
    with open(os.path.join(expdir, "wer_dev.json")) as f:
        res = json.load(f)
    assert res["num_words"] == 37 and res["mode"] == "beam"
    assert res["rtf"] > 0 and np.isfinite(res["wer"])
    with open(os.path.join(expdir, "check", "metrics.jsonl")) as f:
        rounds = [json.loads(line) for line in f if "dev_loss" in line]
    assert [r["epoch"] for r in rounds] == [1, 2]
    with open(os.path.join(expdir, "readme.md")) as f:
        assert "- devices: cpu x1" in f.read()
    with open(os.path.join(expdir, "decode_dev.txt")) as f:
        assert len(f.read().splitlines()) == 20


def _sharded_expdir(yesno, tmp_path, template, **opts):
    """`template` with its train set streamed from npz shards of 16
    utterances (the options of `tests/test_pipeline.py`'s sharded runs),
    written with the stage-1 tokenizer; returns (expdir, hyper)."""
    shards = tmp_path / "shards"

    def edit(hyper, config):
        hyper["train"]["option"].update(
            sharded_data=str(shards), shuffle_buffer=32, buckets=[64, 128],
            frame_budget=800, **opts)

    expdir, hyper, _ = _expdir(tmp_path / "exp", yesno, template, edit)
    asr.main([expdir, "--stop_stage", "1", "--device", "cpu"])
    tok = tknz.load(os.path.join(expdir, "tokenizer.tknz"))
    n = write_shards(str(shards), asr.extract_features(
        str(yesno / "train"), hyper["feature"], "cpu"), tok, shard_size=16)
    assert n == 4  # several shards: the shard shuffle is exercised
    return expdir, hyper


def test_sharded_crf_training_packs_dev_only(yesno, tmp_path):
    expdir, hyper = _sharded_expdir(yesno, tmp_path, "asr-ctc-crf",
                                    max_epochs=1)
    asr.main([expdir, "--start_stage", "2", "--stop_stage", "3",
              "--device", "cpu"])
    assert os.listdir(os.path.join(expdir, "pkl")) == ["dev"]
    with open(os.path.join(expdir, "check", "metrics.jsonl")) as f:
        rounds = [json.loads(line) for line in f if "dev_loss" in line]
    assert [r["epoch"] for r in rounds] == [1]
    assert np.isfinite(rounds[0]["dev_loss"])
    # the denominator of the label-only pass over the shards
    os.makedirs(tmp_path / "jax")
    jax_asr.build_den(str(tmp_path / "jax"), hyper, jax_tknz.load(
        os.path.join(expdir, "tokenizer.tknz")), None,
        shard_pattern=str(tmp_path / "shards" / "shard-*.npz"))
    want = np.load(tmp_path / "jax" / "den_dense.npz")
    got = np.load(os.path.join(expdir, "den_dense.npz"))
    assert got["logw"].shape == (4, 4, 4)
    for k in ("logw", "final"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


@pytest.mark.slow
def test_asr_ctc_from_shards_reaches_the_wer_gate(yesno, tmp_path):
    expdir, _ = _sharded_expdir(yesno, tmp_path, "asr-ctc", max_epochs=100)
    asr.main([expdir, "--start_stage", "2", "--device", "cpu"])
    with open(os.path.join(expdir, "wer_dev.json")) as f:
        res = json.load(f)
    assert not os.path.exists(os.path.join(expdir, "pkl", "train"))
    assert res["errors"] <= 1 and res["num_words"] == 37, res


RECIPES = ["iumien/exp/crf-joinap", "cv-lang10/exp/multi-phoneme",
           "wsj/exp/crf-tdnn", "wenetspeech/exp/crf-wds",
           "wenetspeech/exp/rnnt-wds", "aishell/exp/rnnt-cuside",
           "template/exp/asr-rnnt-cuside"]


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_passes_the_checks_and_builds(tmp_path, name):
    src = os.path.join(REPO, "egs", *name.split("/"))
    with open(os.path.join(src, "hyper-p.json")) as f:
        hyper = json.load(f)
    with open(os.path.join(src, "config.json")) as f:
        config = json.load(f)
    asr.check_train(hyper, config)
    asr.check_decode(hyper, config)
    V = 72
    kw = config["encoder"]["kwargs"]
    if "pv_path" in kw:  # the recipe's phonological matrix, stubbed
        kw["pv_path"] = str(tmp_path / "phono_vec.npy")
        np.save(kw["pv_path"], np.random.default_rng(0).standard_normal(
            (V, 51)).astype(np.float32))
    if hyper["tokenizer"]["type"] == "BpeTokenizer":
        V = hyper["tokenizer"]["option-init"]["vocab_size"]
    model = tasks.train_module(hyper["train"]["bin"]).build_model(
        asr._with_feat_dim(config, 80), num_classes=V, device="cpu")
    if type(model).__name__ in ("TransducerModel", "UnifiedTransducerModel"):
        fc = getattr(model.joiner, "fc_out", None) or model.joiner.fc_enc
        assert fc.kernel.shape[-1] == V
        return
    if "pv_path" in kw:
        assert model.P.shape == (V, 51) and "P" not in model.state_dict()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 64, 80)).astype(np.float32))
    with torch.no_grad():
        out, olens = model(x, torch.tensor([64]))
    assert out.dtype == torch.float32 and out.shape[-1] == V
    assert out.shape[1] == int(olens[0]) and torch.isfinite(out).all()


def _hyper(**kw):
    hyper = {"data": {"train": "t", "dev": "d"},
             "tokenizer": {"type": "SimpleTokenizer"},
             "train": {"bin": "cat_tpu.ctc.train", "option": {}},
             "inference": {"decode": {}}}
    for path, value in kw.items():
        node = hyper
        keys = path.split("__")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return hyper


# the JSA-SPG cases (an EmbeddingEncoder encoder, the ctc.train_jsa bin)
# pass since the JSA slice (tests/test_torch_jsa.py), the P2G bin under
# either package's name since the P2G slice (P2G below); their places
# hold the Wav2Vec2Encoder and §A.6b's BLSTMN and TDNN_LSTM encoders
UNPORTED = [
    (_hyper(den_lm={"path": "den.fst"}), {"trainer": {"loss": "crf"}},
     "§A.6"),
    (_hyper(den_lm={"order": 4}), {"trainer": {"loss": "crf"}}, "§A.6"),
    (_hyper(), {"encoder": {"type": "VGGLSTM"}}, "§A.6"),
    (_hyper(), {"encoder": {"type": "JoinAPLinearEncoder", "kwargs": {
        "enc_head_type": "ConformerLSTM"}}}, "§A.6"),
    (_hyper(), {"encoder": {"type": "Wav2Vec2Encoder"}}, "§A.8"),
    (_hyper(), {"parallel": {"model": 2}}, "§A.7"),
    (_hyper(data={"train": ["a", "b"], "dev": "d"}), {}, "§A.8"),
    (_hyper(), {"encoder": {"type": "BLSTMN"}}, "§A.6"),
    (_hyper(), {"encoder": {"type": "TDNN_LSTM"}}, "§A.6"),
]


# the §A.4 cases of UNPORTED before the streaming slice: they pass now
STREAMING = [_hyper(inference__decode__mode="streaming"),
             _hyper(train__bin="cat_tpu.ctc.train_unified"),
             _hyper(train__bin="cat_tpu.rnnt.train_unified")]


@pytest.mark.parametrize("hyper", STREAMING)
def test_streaming_paths_pass_the_checks(hyper):
    asr.check_train(hyper, {})
    asr.check_decode(hyper, {})
    assert tasks.train_module(hyper["train"]["bin"]) is not None


# the §A.8 ME2E case of UNPORTED before the multichannel slice: its four
# bins, under either package's name, pass now and have a task adapter
ME2E = [_hyper(train__bin=f"{pkg}.ctc.{b}")
        for pkg in ("cat_tpu", "cat_tpu_torch")
        for b in ("train_me2e", "train_me2e_chunk", "train_me2e_kaldi",
                  "train_me2e_kaldi_chunk")]


@pytest.mark.parametrize("hyper", ME2E)
def test_me2e_bins_pass_the_checks(hyper):
    asr.check_train(hyper, {"trainer": {"loss": "crf"}})
    asr.check_decode(hyper, {})
    task = tasks.get_task(hyper)
    assert task.module() is tasks.train_module(hyper["train"]["bin"])
    assert task.chunk == hyper["train"]["bin"].endswith("_chunk")


# the §A.8 P2G cases of UNPORTED before the P2G slice: the bin, under
# either package's name, passes now and has the P2G adapter
P2G = [_hyper(train__bin=f"{pkg}.p2g.train")
       for pkg in ("cat_tpu", "cat_tpu_torch")]


@pytest.mark.parametrize("hyper", P2G)
def test_p2g_bins_pass_the_checks(hyper):
    config = {"p2g": {"kwargs": {"hdim": 32}}}
    asr.check_train(hyper, config)
    asr.check_decode(hyper, config)
    task = tasks.get_task(hyper)
    assert isinstance(task, tasks.P2gTask)
    assert task.module() is tasks.train_module(hyper["train"]["bin"])
    assert task.tokenizer_corpus_file("tokenizer") == "src"
    assert task.tokenizer_corpus_file("tokenizer_grapheme") == "text"
    assert not tasks.NOT_PORTED


@pytest.mark.parametrize("name", ["aishell4/exp/me2e-mvdr",
                                  "template/exp/asr-me2e"])
def test_me2e_recipe_passes_the_checks_and_builds(name):
    """The recipe's own files: the checks pass and its model (aishell4's at
    full width: 8 channels, fft 512, DNN-WPE, mask nets of 256, a 12-cell
    conformer) maps a short multichannel wave to finite logits."""
    src = os.path.join(REPO, "egs", *name.split("/"))
    with open(os.path.join(src, "hyper-p.json")) as f:
        hyper = json.load(f)
    with open(os.path.join(src, "config.json")) as f:
        config = json.load(f)
    asr.check_train(hyper, config)
    asr.check_decode(hyper, config)
    V = 12
    model = tasks.get_task(hyper).module().build_model(config, V,
                                                       device="cpu")
    fe = model.frontend
    C = hyper["feature"]["channels"]
    L = fe.frame_length + 31 * fe.frame_shift
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, C, L)).astype(np.float32) * 0.1)
    with torch.no_grad():
        out, olens = model(x, torch.tensor([L]))
    assert fe.sample_rate == hyper["feature"]["sample_rate"]
    assert out.shape[-1] == V and out.shape[1] == int(olens[0])
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("hyper,config,section", UNPORTED)
def test_unported_paths_name_their_section(tmp_path, hyper, config,
                                           section):
    for name, obj in (("hyper-p.json", hyper), ("config.json", config)):
        with open(tmp_path / name, "w") as f:
            json.dump(obj, f)
    with pytest.raises(NotImplementedError, match=section):
        asr.main([str(tmp_path), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == ["config.json", "hyper-p.json"]


def test_unported_denominators_name_their_section(tmp_path):
    tok = tknz.RawTokenizer(200)
    with pytest.raises(NotImplementedError, match="§A.6"):
        asr.build_den(str(tmp_path), {}, tok, None)
    np.savez(tmp_path / "graph.npz", arcs=np.zeros(3))
    with pytest.raises(NotImplementedError, match="§A.6"):
        asr.build_den(str(tmp_path), {"den_lm": {"path": str(
            tmp_path / "graph.npz")}}, tknz.RawTokenizer(8), None)


def test_pipeline_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        asr.main([str(tmp_path)])


def test_config_perf_is_read_and_ignored(yesno, tmp_path, capsys):
    def edit(hyper, config):
        config["perf"] = {"fused_ffn": "1"}

    expdir, _, _ = _expdir(tmp_path / "exp", yesno, "asr-ctc", edit)
    asr.main([expdir, "--stop_stage", "1", "--device", "cpu"])
    assert "config.perf" in capsys.readouterr().out


def test_one_bin_map_serves_the_pipeline_and_both_clis(tmp_path,
                                                       monkeypatch):
    from cat_tpu_torch.ctc import decode as ctc_decode
    from cat_tpu_torch.ctc import train as ctc_train
    from cat_tpu_torch.rnnt import decode as rnnt_decode
    from cat_tpu_torch.rnnt import train as rnnt_train
    from cat_tpu_torch.ctc import train_unified as ctc_unified
    from cat_tpu_torch.rnnt import train_unified as rnnt_unified
    for pkg in ("cat_tpu", "cat_tpu_torch"):
        assert tasks.train_module(f"{pkg}.ctc.train") is ctc_train
        assert tasks.train_module(f"{pkg}.rnnt.train") is rnnt_train
        assert tasks.train_module(f"{pkg}.ctc.train_unified") is ctc_unified
        assert tasks.train_module(f"{pkg}.rnnt.train_unified",
                                  "rnnt") is rnnt_unified
        assert tasks.is_unified(f"{pkg}.rnnt.train_unified")
    with pytest.raises(ValueError, match="not a ctc trainer"):
        tasks.train_module("cat_tpu.rnnt.train", "ctc")
    assert not hasattr(ctc_decode, "_TRAIN_BINS")
    assert not hasattr(rnnt_decode, "_TRAIN_BINS")

    asked = []

    class Asked(Exception):
        pass

    def train_module(name, want_family=None):
        asked.append((name, want_family))
        raise Asked

    monkeypatch.setattr(tasks, "train_module", train_module)
    tknz.SimpleTokenizer(["a"]).save(str(tmp_path / "tokenizer.tknz"))
    for cli, family in ((ctc_decode, "ctc"), (rnnt_decode, "rnnt")):
        with open(tmp_path / "hyper-p.json", "w") as f:
            json.dump({"tokenizer": {"file": "tokenizer.tknz"},
                       "train": {"bin": f"cat_tpu.{family}.train"}}, f)
        with open(tmp_path / "config.json", "w") as f:
            json.dump({}, f)
        with pytest.raises(Asked):
            cli.main([str(tmp_path), "--device", "cpu"])
        assert asked[-1] == (f"cat_tpu.{family}.train", family)
        with pytest.raises(Asked):
            asr.main([str(tmp_path), "--device", "cpu"])
        assert asked[-1] == (f"cat_tpu.{family}.train", None)


def _train_to_the_end(yesno, tmp_path, template):
    expdir, _, _ = _expdir(tmp_path / "exp", yesno, template)
    asr.main([expdir, "--device", "cpu"])
    with open(os.path.join(expdir, "wer_dev.json")) as f:
        return json.load(f)


@pytest.mark.slow
def test_asr_ctc_template_trains_to_at_most_2_word_errors(yesno, tmp_path):
    res = _train_to_the_end(yesno, tmp_path, "asr-ctc")
    assert res["errors"] <= 2 and res["num_words"] == 37, res


@pytest.fixture(scope="module")
def yesno_big(tmp_path_factory):
    """The JAX package's larger toy set for transducers
    (`tests/test_pipeline.py` `yesno_data_big`: 160 train and 20 dev
    utterances, seed 7)."""
    sys.path.insert(0, os.path.join(REPO, "egs", "template", "local"))
    import make_data

    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("yesno_big")
    for split, n in (("train", 160), ("dev", 20)):
        d = root / split
        (d / "wav").mkdir(parents=True)
        scp, text = [], []
        for i in range(n):
            words = list(rng.choice(["yes", "no"],
                                    size=int(rng.integers(1, 4))))
            uid = f"{split}_{i:03d}"
            write_wav(str(d / "wav" / (uid + ".wav")),
                      make_data.make_utt(rng, words), make_data.SR)
            scp.append(f"{uid} {d / 'wav' / (uid + '.wav')}")
            text.append(f"{uid} {' '.join(words)}")
        (d / "wav.scp").write_text("\n".join(scp) + "\n")
        (d / "text").write_text("\n".join(text) + "\n")
    return root


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rnnt_toy_trains_to_at_most_2_word_errors(yesno_big, tmp_path,
                                                  monkeypatch, seed):
    """The asr-rnnt template with the JAX package's own converging toy
    transducer (`tests/test_pipeline.py` `test_pipeline_yesno_rnnt_simple`:
    a 16-wide predictor, the LogAdd joiner, the patient scheduler, up to
    150 epochs), from four random initialisations (`build_model`'s seed);
    the JAX package's run reaches 2 dev errors of 42. The template's own
    15 epochs on 64 utterances stop short of convergence."""
    from cat_tpu_torch.rnnt import train as rnnt_train
    build = rnnt_train.build_model
    monkeypatch.setattr(rnnt_train, "build_model",
                        lambda *a, **kw: build(*a, **kw, seed=seed))

    def edit(hyper, config):
        hyper["train"]["option"].update(frame_budget=500, max_epochs=150)
        config["predictor"]["kwargs"]["hdim"] = 16
        config["joiner"] = {"type": "LogAdd", "kwargs": {}}
        config["scheduler"]["kwargs"] = {"min_step": 1600, "stop_lr": 5e-5,
                                         "n_tol": 6, "gamma": 0.5}

    expdir, _, _ = _expdir(tmp_path / "exp", yesno_big, "asr-rnnt", edit)
    asr.main([expdir, "--device", "cpu"])
    with open(os.path.join(expdir, "wer_dev.json")) as f:
        res = json.load(f)
    print(f"seed {seed}: {res['errors']} dev word errors of "
          f"{res['num_words']}")
    assert res["errors"] <= 2, res


@pytest.mark.slow
def test_asr_rnnt_cuside_template_trains_to_its_end(yesno_big, tmp_path):
    """The asr-rnnt-cuside template as it stands (150 epochs at most,
    early stop) on the larger toy set: streaming decoding of dev, then
    offline greedy decoding of the same averaged checkpoint; both WERs
    finite."""
    expdir, _, _ = _expdir(tmp_path / "exp", yesno_big, "asr-rnnt-cuside")
    asr.main([expdir, "--device", "cpu"])
    res = {}
    for mode in ("streaming", "greedy"):
        if mode == "greedy":
            with open(os.path.join(expdir, "hyper-p.json")) as f:
                hyper = json.load(f)
            hyper["inference"]["decode"]["mode"] = "greedy"
            with open(os.path.join(expdir, "hyper-p.json"), "w") as f:
                json.dump(hyper, f)
            asr.main([expdir, "--start_stage", "4", "--device", "cpu"])
        with open(os.path.join(expdir, "wer_dev.json")) as f:
            res[mode] = json.load(f)
        assert res[mode]["mode"] == mode and np.isfinite(res[mode]["wer"])
    print({m: r["wer"] for m, r in res.items()})
