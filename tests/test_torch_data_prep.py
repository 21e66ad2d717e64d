"""Port parity for data preparation: the CLI `python -m
cat_tpu_torch.utils.data_prep` against `cat_tpu.utils.data_prep` on toy
WAVs with a `segments` file and `--speed-perturb 0.9 1.1`, both packed
output directories read back with the JAX package's `SpeechDataset`.

Tolerances: uids, their order and the labels equal; features (fbank +
CMVN) within |Δ| <= 1e-3 + 1e-4·|x| of JAX's (the tones carry noise of
0.01 in every frame, so every mel bin is resolved in f32; measured
maximum printed).
"""
import os

import numpy as np
import pytest

from cat_tpu.utils import data_prep as jax_prep
from cat_tpu.utils.audio import write_wav
from cat_tpu.utils.data import SpeechDataset
from cat_tpu.utils.tokenizer import SimpleTokenizer
from cat_tpu_torch.utils import data_prep

ATOL, RTOL = 1e-3, 1e-4


def _tone(path, seconds, freq, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * freq * t) + 0.01 * rng.standard_normal(
        t.shape)
    write_wav(str(path), x.astype(np.float32), sr)


def _manifest(d, sr, segments):
    d.mkdir()
    scp, text, seg = [], [], []
    for r in range(2):
        _tone(d / f"rec{r}.wav", 1.0 + 0.3 * r, 300 + 250 * r, sr, seed=r)
        scp.append(f"rec{r} {d / f'rec{r}.wav'}")
        if segments:
            for k, (s, e) in enumerate(((0.0, 0.4), (0.45, 0.95))):
                uid = f"rec{r}-{k}"
                seg.append(f"{uid} rec{r} {s:.2f} {e:.2f}")
                text.append(f"{uid} {'ab' if k else 'ba'} c")
        else:
            text.append(f"rec{r} ab c{'a' * r}")
    (d / "wav.scp").write_text("\n".join(scp) + "\n")
    (d / "text").write_text("\n".join(text) + "\n")
    if segments:
        (d / "segments").write_text("\n".join(seg) + "\n")


@pytest.mark.parametrize("sr,segments", [(16000, True), (8000, False)])
def test_data_prep_cli_matches_jax(tmp_path, sr, segments):
    d = tmp_path / "manifest"
    _manifest(d, sr, segments)
    tok = SimpleTokenizer.from_corpus(["ab c", "ba c", "ab ca"], level="char")
    tok.save(str(tmp_path / "tok.tknz"))
    args = [str(d), "--tokenizer", str(tmp_path / "tok.tknz"),
            "--num-mel-bins", "40", "--speed-perturb", "0.9", "1.1"]
    jax_prep.main([args[0], str(tmp_path / "jax")] + args[1:])
    data_prep.main([args[0], str(tmp_path / "port")] + args[1:]
                   + ["--device", "cpu"])
    want = SpeechDataset(str(tmp_path / "jax"))
    got = SpeechDataset(str(tmp_path / "port"))
    assert got.uids == want.uids and len(got) == 3 * (4 if segments else 2)
    assert any(u.startswith("sp0.9-") for u in got.uids)
    assert got.feat_dim == want.feat_dim == 40
    worst = 0.0
    for i in range(len(want)):
        (gf, gl), (wf, wl) = got[i], want[i]
        np.testing.assert_array_equal(gl, wl)
        assert gf.shape == wf.shape
        err = np.abs(gf - wf)
        assert (err <= ATOL + RTOL * np.abs(wf)).all(), (i, err.max())
        worst = max(worst, float(err.max()))
    print(f"features max abs err {worst:.3g}")


def test_data_prep_refuses_what_is_not_ported(tmp_path):
    d = tmp_path / "manifest"
    _manifest(d, 8000, False)
    with pytest.raises(NotImplementedError, match="§A.8"):
        data_prep.main([str(d), str(tmp_path / "out"), "--tokenizer",
                        "unused.tknz", "--device", "cpu", "--channels", "2"])
    assert not os.path.exists(tmp_path / "out")


def test_data_prep_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        data_prep.prepare(str(tmp_path), str(tmp_path / "out"), None)
