"""The P2G task adapter (`cat_tpu_torch/pipeline/tasks.py` `P2gTask`)
through `python -m cat_tpu_torch.pipeline.asr` on the CPU:

- the three P2G recipes (llm-p2g danp and tkm, template p2g-danp) pass
  the stage 3 and 4 checks as their files stand, get the adapter, and
  their models (llm-p2g's at full width: hdim 512, 6 + 6 layers, 8 heads)
  map a token batch to finite logits;
- template p2g-danp's stages 1-4 on `egs/template/local/make_data_p2g.py`
  data, in mode "ce" and in mode "tkm" with marginalised decoding (as
  tests/test_pipeline_tasks.py runs the JAX package's): max_epochs 250
  cut to 20, then at most 5 % word errors on dev.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cat_tpu_torch.p2g import train as p2g
from cat_tpu_torch.pipeline import asr, tasks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = ["llm-p2g/exp/danp", "llm-p2g/exp/tkm", "template/exp/p2g-danp"]
EPOCHS = 20  # template p2g-danp: max_epochs 250 cut to 20


def recipe(name):
    src = os.path.join(REPO, "egs", *name.split("/"))
    with open(os.path.join(src, "hyper-p.json")) as f:
        hyper = json.load(f)
    with open(os.path.join(src, "config.json")) as f:
        config = json.load(f)
    return hyper, config


@pytest.mark.parametrize("name", RECIPES)
def test_p2g_recipe_passes_the_checks_and_builds(name):
    hyper, config = recipe(name)
    asr.check_train(hyper, config)
    asr.check_decode(hyper, config)
    task = tasks.get_task(hyper)
    assert isinstance(task, tasks.P2gTask) and task.module() is p2g
    Vs, Vt = 40, 500
    model = p2g.build_model(config, Vs, Vt, device="cpu")
    kw = config["p2g"]["kwargs"]
    assert len(model.encoder.cells) == kw["enc_layers"]
    assert len(model.decoder.blocks) == kw["dec_layers"]
    assert model.decoder.head.kernel.shape == (kw["hdim"], Vt)
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.integers(1, Vs, (2, 12)))
    tgt = torch.from_numpy(rng.integers(1, Vt, (2, 5)))
    with torch.no_grad():
        out = model(src, torch.tensor([12, 7]), tgt, torch.tensor([5, 2]))
    assert out.shape == (2, 5, Vt) and torch.isfinite(out).all()


@pytest.fixture(scope="module")
def p2g_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("p2g_data")
    subprocess.run([sys.executable, os.path.join(
        REPO, "egs", "template", "local", "make_data_p2g.py"), str(root)],
        check=True, capture_output=True)
    return root


@pytest.mark.parametrize("mode", ["ce", "tkm"])
def test_template_p2g_danp_stages_1_to_4(p2g_data, tmp_path, mode):
    hyper, config = recipe("template/exp/p2g-danp")
    hyper["data"] = {"train": str(p2g_data / "train"),
                     "dev": str(p2g_data / "dev")}
    hyper["train"]["option"].update(mode=mode, max_epochs=EPOCHS)
    if mode == "tkm":
        hyper["inference"]["decode"]["marginalize"] = True
        hyper["tkm"] = {"k": 3, "temperature": 1.0}
    expdir = tmp_path / "exp"
    expdir.mkdir()
    for name, obj in (("hyper-p.json", hyper), ("config.json", config)):
        with open(expdir / name, "w") as f:
            json.dump(obj, f)
    asr.main([str(expdir), "--device", "cpu"])
    for split in ("train", "dev"):
        assert (expdir / "pkl" / split / "seq2seq.npz").exists()
    with open(expdir / "check" / "checkpoint.list") as f:
        assert len(f.read().splitlines()) >= 1
    with open(expdir / "wer_dev.json") as f:
        res = json.load(f)
    assert res["wer"] < 5.0, res
    assert res["mode"] == ("marginalize" if mode == "tkm" else "greedy")
    assert len((expdir / "decode_dev.txt").read_text().splitlines()) == 30
    assert f"p2g {mode}" in (expdir / "readme.md").read_text()
