"""Port parity of the LM pipeline (`cat_tpu_torch.pipeline.lm`) and the
LM CLIs (`python -m cat_tpu_torch.lm {ppl,rescore}`) against
`cat_tpu.pipeline.lm` and `cat_tpu.lm`, on a seeded word corpus (the
JAX package's `tests/test_lm_pipeline.py` corpus), with the template
recipes egs/template/exp/lm-nn and lm-trf, their data paths set and
their epochs cut:

- stages 1-2 build JAX's tokenizer and pack its corpus.npz byte for byte;
- stage 4 on an expdir that JAX's pipeline trained writes JAX's ppl.json
  ({"ppl"}, lm-nn; {"trf_score_mean"}, lm-trf) within 1e-5 relative;
- the port's own stage 3 lowers lm-nn's dev perplexity below the
  untrained model's, and trains lm-trf to a finite mean score;
- `ppl` and `rescore` with an LM expdir print and write what the JAX
  package's CLIs do (perplexity within 1e-5, the same rescored text);
- an LM bin given to `pipeline.asr` is refused, naming `pipeline.lm`.
"""
import json
import os
import pickle
import runpy
import shutil
import sys

import numpy as np
import pytest

from cat_tpu.pipeline import lm as jax_lm
from cat_tpu_torch.lm import __main__ as lm_cli
from cat_tpu_torch.pipeline import asr
from cat_tpu_torch.pipeline import lm
from cat_tpu_torch.utils import tokenizer as tknz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["the", "cat", "dog", "sat", "ran", "on", "mat"]


def write_corpus(root):
    rng = np.random.default_rng(0)

    def sent():
        return " ".join(["the"] + [WORDS[int(rng.integers(1, len(WORDS)))]
                                   for _ in range(int(rng.integers(3, 7)))])

    paths = {}
    for split, n in (("train", 120), ("dev", 20)):
        paths[split] = str(root / f"{split}.txt")
        with open(paths[split], "w") as f:
            f.write("\n".join(sent() for _ in range(n)) + "\n")
    return paths


def recipe(path, template, data, **option):
    src = os.path.join(REPO, "egs", "template", "exp", template)
    with open(os.path.join(src, "hyper-p.json")) as f:
        hyper = json.load(f)
    with open(os.path.join(src, "config.json")) as f:
        config = json.load(f)
    hyper["data"] = dict(data)
    hyper["train"]["option"].update(option)
    os.makedirs(path)
    for name, obj in (("hyper-p.json", hyper), ("config.json", config)):
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f)
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """JAX's pipeline through stage 3 on lm-nn (3 epochs) and lm-trf (1
    epoch); returns the corpus paths and the two expdirs."""
    root = tmp_path_factory.mktemp("lm")
    data = write_corpus(root)
    exps = {"lm-nn": recipe(root / "lm-nn", "lm-nn", data, max_epochs=3),
            "lm-trf": recipe(root / "lm-trf", "lm-trf", data, max_epochs=1)}
    for d in exps.values():
        jax_lm.main([d, "--stop_stage", "3"])
    return data, exps


def _ppl_json(d):
    with open(os.path.join(d, "ppl.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("template", ["lm-nn", "lm-trf"])
def test_stages_1_2_match_jax(trained, tmp_path, template):
    data, exps = trained
    d = recipe(tmp_path / "port", template, data)
    lm.main([d, "--stop_stage", "2", "--device", "cpu"])
    assert tknz.load(os.path.join(d, "tokenizer.tknz"))._i2t == \
        tknz.load(os.path.join(exps[template], "tokenizer.tknz"))._i2t
    for split in ("train", "dev"):
        with open(os.path.join(d, "pkl", split, "corpus.npz"), "rb") as f, \
                open(os.path.join(exps[template], "pkl", split,
                                  "corpus.npz"), "rb") as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("template,key", [("lm-nn", "ppl"),
                                          ("lm-trf", "trf_score_mean")])
def test_stage_4_on_a_jax_trained_expdir_matches_jax(trained, tmp_path,
                                                     template, key):
    _, exps = trained
    d = str(tmp_path / template)
    shutil.copytree(exps[template], d)
    jax_lm.main([d, "--start_stage", "4"])
    want = _ppl_json(d)
    os.remove(os.path.join(d, "ppl.json"))
    lm.main([d, "--start_stage", "4", "--device", "cpu"])
    got = _ppl_json(d)
    assert got.keys() == want.keys() == {key}
    np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    assert np.isfinite(got[key])


def test_stage_3_lowers_dev_perplexity(trained, tmp_path):
    data, _ = trained
    d = recipe(tmp_path / "lm-nn", "lm-nn", data, max_epochs=4,
               token_budget=200)
    lm.main([d, "--stop_stage", "2", "--device", "cpu"])
    from cat_tpu_torch.lm import train as ptrain

    config = lm.load_json(os.path.join(d, "config.json"))
    tok = tknz.load(os.path.join(d, "tokenizer.tknz"))
    untrained = ptrain.perplexity(
        ptrain.build_model(config, tok.vocab_size, device="cpu"),
        [tok.encode(s) for s in open(data["dev"]).read().splitlines()])
    lm.main([d, "--start_stage", "3", "--device", "cpu"])
    ppl = _ppl_json(d)["ppl"]
    assert ppl < 0.6 * untrained and ppl < tok.vocab_size, (ppl, untrained)
    with open(os.path.join(d, "check", "checkpoint.list")) as f:
        assert len(f.read().splitlines()) == 4


def test_trf_stage_3_trains_to_a_finite_score(trained, tmp_path):
    data, _ = trained
    d = recipe(tmp_path / "lm-trf", "lm-trf", data, max_epochs=2)
    lm.main([d, "--device", "cpu"])
    assert np.isfinite(_ppl_json(d)["trf_score_mean"])
    with open(os.path.join(d, "check", "metrics.jsonl")) as f:
        rounds = [json.loads(line) for line in f if "dev_loss" in line]
    assert len(rounds) == 2 and all(np.isfinite(r["dev_loss"])
                                    for r in rounds)


def _jax_cli(argv, capsys):
    """`python -m cat_tpu.lm ...` in-process (its __main__ runs at
    import)."""
    old = sys.argv
    sys.argv = ["cat_tpu.lm"] + argv
    try:
        runpy.run_module("cat_tpu.lm", run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out


def test_ppl_cli_matches_jax(trained, capsys):
    data, exps = trained
    want = json.loads(_jax_cli(["ppl", exps["lm-nn"], data["dev"]],
                               capsys).splitlines()[-1])
    lm_cli.main(["ppl", exps["lm-nn"], data["dev"], "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert got.keys() == {"ppl"}
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)


@pytest.mark.parametrize("search", [False, True])
def test_rescore_cli_with_an_lm_expdir_matches_jax(trained, tmp_path,
                                                   capsys, search):
    data, exps = trained
    rng = np.random.default_rng(5)
    dev = open(data["dev"]).read().splitlines()
    nbest, refs = {}, {}
    for i, ref in enumerate(dev[:8]):
        uid = f"u{i:02d}"
        refs[uid] = ref
        hyps = [ref] + [" ".join(rng.permutation(ref.split()))
                        for _ in range(3)]
        nbest[uid] = {k: (float(-rng.uniform(5, 6)), h)
                      for k, h in enumerate(hyps)}
    nb = tmp_path / "nbest.pkl"
    with open(nb, "wb") as f:
        pickle.dump(nbest, f)
    ref = tmp_path / "ref.txt"
    ref.write_text("".join(f"{u}\t{t}\n" for u, t in refs.items()))
    extra = ["--search"] if search else []
    args = [str(nb), exps["lm-nn"], "--alpha", "0.7", "--beta", "0.1",
            "--ref", str(ref)] + extra
    want = _jax_cli(["rescore"] + args + ["--output",
                                          str(tmp_path / "jax.txt")], capsys)
    lm_cli.main(["rescore"] + args + ["--output", str(tmp_path / "port.txt"),
                                      "--device", "cpu"])
    got = capsys.readouterr().out
    assert [json.loads(x) for x in got.splitlines()] == \
        [json.loads(x) for x in want.splitlines()]
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()


@pytest.mark.parametrize("bin_", ["cat_tpu.lm.train",
                                  "cat_tpu_torch.lm.train_trf"])
def test_pipeline_asr_refuses_an_lm_bin(tmp_path, bin_):
    hyper = {"data": {"train": "t", "dev": "d"},
             "tokenizer": {"type": "SimpleTokenizer"},
             "train": {"bin": bin_, "option": {}}}
    for name, obj in (("hyper-p.json", hyper), ("config.json", {})):
        with open(tmp_path / name, "w") as f:
            json.dump(obj, f)
    with pytest.raises(ValueError, match="pipeline.lm"):
        asr.main([str(tmp_path), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == ["config.json", "hyper-p.json"]


def test_pipeline_lm_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.main([str(tmp_path)])
