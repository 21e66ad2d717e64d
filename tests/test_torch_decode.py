"""Port parity for CTC decoding: the host searches against cat_tpu's on
the same log-probs, the decode CLI end to end against
`cat_tpu.ctc.decode.main` on an experiment written by cat_tpu's own
helpers, and the port's import hygiene (no JAX, flax, optax or cat_tpu).
"""
import os
import pickle
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

import jax
import optax

from cat_tpu.ctc import decode as jax_decode
from cat_tpu.fst.ngram import train_ngram
from cat_tpu.models.encoders import ConformerNet as JaxConformerNet
from cat_tpu.utils.checkpoint import CheckpointManager
from cat_tpu.utils.data import pack_speech_data
from cat_tpu.utils.manager import TrainState
from cat_tpu.utils.tokenizer import SimpleTokenizer
from cat_tpu_torch.ctc import decode

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _log_probs(N, T, V, seed):
    x = np.random.default_rng(seed).standard_normal((N, T, V)) * 2
    return np.asarray(jax.nn.log_softmax(x.astype(np.float32), -1))


def test_greedy_matches_jax():
    lp = _log_probs(3, 30, 7, seed=0)
    lengths = np.array([30, 22, 5])
    assert decode.greedy_decode(torch.tensor(lp), lengths) == \
        jax_decode.greedy_decode(lp, lengths)


@pytest.mark.parametrize("with_lm", [False, True])
def test_prefix_beam_matches_jax(with_lm):
    lp = _log_probs(2, 12, 5, seed=1)
    kw = dict(beam_width=6, nbest=3, beta=0.5)
    if with_lm:
        kw.update(lm=train_ngram([[1, 2, 3], [2, 3, 4], [1, 3]], order=2),
                  alpha=0.7)
    got = decode.batch_prefix_beam_search(lp, [12, 9], **kw)
    want = jax_decode.batch_prefix_beam_search(lp, [12, 9], **kw)
    assert [[p for _, p in n] for n in got] == [[p for _, p in n]
                                                for n in want]
    np.testing.assert_allclose([[s for s, _ in n] for n in got],
                               [[s for s, _ in n] for n in want], rtol=1e-6)


def _expdir(root):
    """A tiny experiment written with cat_tpu's own helpers."""
    kw = dict(num_cells=2, hdim=128, num_heads=2, kernel_size=15,
              dropout_rate=0.0, scan_layers=True)
    tok = SimpleTokenizer(list("abcdefgh"), level="char")
    tok.save(os.path.join(root, "tokenizer.tknz"))
    with open(os.path.join(root, "config.json"), "w") as f:
        f.write('{"encoder": {"type": "ConformerNet", "kwargs": %s}}'
                % str(kw).replace("'", '"').replace("True", "true"))
    with open(os.path.join(root, "hyper-p.json"), "w") as f:
        f.write('{"tokenizer": {"file": "tokenizer.tknz"}, '
                '"train": {"bin": "cat_tpu.ctc.train"}}')
    rng = np.random.default_rng(3)
    utts = [(f"utt{i}", rng.standard_normal((n, 80)).astype(np.float32),
             [2, 3]) for i, n in enumerate((44, 29))]
    pack_speech_data(os.path.join(root, "pkl", "dev"), utts)
    model = JaxConformerNet(num_classes=tok.vocab_size, **kw)
    v = jax.jit(partial(model.init, deterministic=True))(
        jax.random.PRNGKey(0), utts[0][1][None], np.array([44]))
    # sharper, varied logits so the searches have something to choose
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(a.shape),
        v["params"])
    params["classifier"]["kernel"] *= 8
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    state = TrainState(params=params, batch_stats=v["batch_stats"],
                       opt_state=tx.init(params), step=np.asarray(0))
    CheckpointManager(os.path.join(root, "check")).save(
        {"state": state}, 1.0, 0, 0)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_decode_cli_matches_jax(tmp_path, mode):
    _expdir(str(tmp_path))
    args = [str(tmp_path), "--mode", mode, "--beam-width", "4",
            "--nbest", "2"]
    jax_decode.main(args + ["--output", str(tmp_path / "jax.txt")])
    decode.main(args + ["--output", str(tmp_path / "port.txt"),
                        "--device", "cpu"])
    got = (tmp_path / "port.txt").read_text()
    assert got == (tmp_path / "jax.txt").read_text()
    assert len(got.splitlines()) == 2 and got.strip()
    with open(tmp_path / "port.txt.nbest.pkl", "rb") as f:
        nb_got = pickle.load(f)
    with open(tmp_path / "jax.txt.nbest.pkl", "rb") as f:
        nb_want = pickle.load(f)
    assert nb_got.keys() == nb_want.keys()
    for uid in nb_want:
        assert [h for _, h in nb_got[uid].values()] == \
            [h for _, h in nb_want[uid].values()]
        np.testing.assert_allclose([s for s, _ in nb_got[uid].values()],
                                   [s for s, _ in nb_want[uid].values()],
                                   rtol=1e-4, atol=1e-3)


def test_decode_cli_refuses_unported_options(tmp_path):
    """Every option of the CLI is ported; what still stops it is a WFST
    decode without its graph, as in JAX, before anything is read."""
    with pytest.raises(SystemExit, match="--graph"):
        decode.main([str(tmp_path), "--mode", "wfst", "--device", "cpu"])


def _tlg_files(root):
    """A TLG over the tiny experiment's char units (JAX's `build_tlg`),
    saved as tlg.npz with its "word id" lines in words.txt."""
    from cat_tpu.fst.decode import build_tlg
    from cat_tpu.utils import tokenizer as tknz
    tok = tknz.load(os.path.join(root, "tokenizer.tknz"))
    words = ["bad", "cab", "face", "hedge", "dig", "gag"]
    word2id = {w: i + 1 for i, w in enumerate(words)}
    lm = train_ngram([["bad", "cab"], ["face"], ["dig", "gag", "bad"],
                      ["hedge", "cab"], ["gag"]], order=2)
    tlg = build_tlg([(w, tok.encode(w)) for w in words], lm,
                    {i: i for i in range(1, tok.vocab_size)}, word2id,
                    num_classes=tok.vocab_size)
    tlg.save(os.path.join(root, "tlg.npz"))
    with open(os.path.join(root, "words.txt"), "w") as f:
        f.writelines(f"{w} {i}\n" for w, i in word2id.items())


@pytest.mark.parametrize("extra", [
    ["--mode", "wfst", "--graph", "tlg.npz", "--words", "words.txt"],
    ["--mode", "wfst", "--graph", "tlg.npz"],
    ["--mode", "beam", "--lm", "lm.arpa", "--alpha", "0.6", "--beta",
     "0.4"],
    ["--mode", "greedy", "--lm", "lm.arpa"]])
def test_decode_cli_wfst_and_lm_match_jax(tmp_path, extra):
    from cat_tpu.fst.ngram import write_arpa
    _expdir(str(tmp_path))
    _tlg_files(str(tmp_path))
    write_arpa(train_ngram([[2, 3, 4], [3, 4, 5, 2], [2, 2, 3]], order=3),
               str(tmp_path / "lm.arpa"))
    extra = [str(tmp_path / a) if a.endswith((".npz", ".txt", ".arpa"))
             else a for a in extra]
    args = [str(tmp_path), "--beam-width", "4", "--nbest", "3", *extra]
    jax_decode.main(args + ["--output", str(tmp_path / "jax.txt")])
    decode.main(args + ["--output", str(tmp_path / "port.txt"),
                        "--device", "cpu"])
    got = (tmp_path / "port.txt").read_text()
    assert got == (tmp_path / "jax.txt").read_text()
    assert len(got.splitlines()) == 2
    with open(tmp_path / "port.txt.nbest.pkl", "rb") as f:
        nb_got = pickle.load(f)
    with open(tmp_path / "jax.txt.nbest.pkl", "rb") as f:
        nb_want = pickle.load(f)
    assert nb_got.keys() == nb_want.keys()
    for uid in nb_want:
        assert [h for _, h in nb_got[uid].values()] == \
            [h for _, h in nb_want[uid].values()]
        np.testing.assert_allclose([s for s, _ in nb_got[uid].values()],
                                   [s for s, _ in nb_want[uid].values()],
                                   rtol=1e-4, atol=1e-3)


def test_port_imports_nothing_of_jax():
    code = """
import importlib, pkgutil, sys
import cat_tpu_torch, chip_smoke
for m in pkgutil.walk_packages(cat_tpu_torch.__path__, "cat_tpu_torch."):
    importlib.import_module(m.name)
for m in ("ops.dropout", "ops.semiring", "ops.ctc", "ops.crf_dense",
          "ops.specaug", "fst.ngram", "utils.scheduler", "utils.manager",
          "utils.tolerance", "ctc.train", "ops.rnnt", "ops.rnnt_simple",
          "rnnt.train", "rnnt.decode", "pipeline.asr", "pipeline.tasks",
          "ctc.decode_device", "ops.fbank", "utils.audio", "utils.wer",
          "utils.nbest", "utils.data_prep", "fst.fst", "fst.graph",
          "fst.decode", "fst.g2p", "native", "lm.rescore", "pipeline.ngram",
          "pipeline.text"):
    assert "cat_tpu_torch." + m in sys.modules, m
import runpy
for tool in ("torch_step_diag", "torch_ffn_ab", "torch_ffn_ablate",
             "torch_attn_ab"):
    runpy.run_path(f"tools/{tool}.py", run_name="imported")
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "cat_tpu"))
assert not bad, bad
print(len([m for m in sys.modules if m.startswith("cat_tpu_torch")]))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 34
    # the pipeline's entry point, with nothing of JAX loaded
    code = """
import runpy, sys
sys.argv = ["asr", "--help"]
try:
    runpy.run_module("cat_tpu_torch.pipeline.asr", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "cat_tpu"))
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--stop_stage" in res.stdout and "--device" in res.stdout
