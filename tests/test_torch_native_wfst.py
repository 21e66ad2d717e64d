"""The port's C++ WFST core (`cat_tpu_torch/native/wfst_decoder.cpp`,
built by `cat_tpu_torch.native` with g++ into build/native/) against
the JAX package's (`cat_tpu/native`) and against the port's Python
search, on the CPU.

- `decode_native` and `decode_native_nbest` give exactly JAX's results
  (word ids and scores equal) on the toy TLG of `tests/test_tlg.py` and
  on seeded random TLGs and log-probs; the 1-best equals the Python
  `WfstDecoder.decode`'s words with scores within 1e-3, as
  `tests/test_native_wfst.py` holds JAX's.
- The build: a hashed library under build/native/, rebuilt when the
  source changes; processes that build at once do not collide; a failed
  build, or no g++, raises with the compiler's output instead of falling
  back to the Python search.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from cat_tpu.fst import decode as jdec
from cat_tpu_torch import native
from cat_tpu_torch.fst import decode as pdec
from tests.test_tlg import am_for
from tests.test_torch_tlg import CASES, random_lp, random_tlg, toy

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def decoders(want, got, **opts):
    return jdec.WfstDecoder(want, **opts), pdec.WfstDecoder(got, **opts)


@needs_gxx
@pytest.mark.parametrize("phones,peak", CASES)
def test_native_matches_jax_on_the_toy(phones, peak):
    jd, pd = decoders(*toy(), beam=30.0)
    lp = am_for(phones, peak=peak)
    got = pd.decode_native(lp, len(lp))
    assert got == jd.decode_native(lp, len(lp))
    py = pd.decode(lp, len(lp))[0]
    assert got[1] == py[1] and abs(got[0] - py[0]) < 1e-3
    nb = pd.decode_native_nbest(lp, len(lp), nbest=4)
    assert nb == jd.decode_native_nbest(lp, len(lp), nbest=4)
    assert nb[0][1] == got[1] and abs(nb[0][0] - got[0]) < 1e-3
    scores = [s for s, _ in nb]
    assert scores == sorted(scores, reverse=True)
    assert len({tuple(w) for _, w in nb}) == len(nb)


@needs_gxx
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("opts", [dict(beam=17.0, max_active=7000),
                                  dict(beam=9.0, max_active=5),
                                  dict(beam=12.0, acoustic_scale=0.6)])
def test_native_matches_jax_on_random_tlgs(seed, opts):
    (want, got), V = random_tlg(seed, 3)
    jd, pd = decoders(want, got, **opts)
    lp = random_lp(10 + seed, 60, V, peak=2.0)
    for length in (60, 17, 0):
        one = pd.decode_native(lp, length)
        assert one == jd.decode_native(lp, length)
        py = pd.decode(lp, length)[0]
        assert one[1] == py[1] and abs(one[0] - py[0]) < 1e-3
        for k in (1, 6):
            nb = pd.decode_native_nbest(lp, length, nbest=k)
            assert nb == jd.decode_native_nbest(lp, length, nbest=k)
            assert nb[0][1] == one[1]


@needs_gxx
def test_native_tables_are_built_once():
    _, got = toy()
    pd = pdec.WfstDecoder(got)
    tabs = pd.native_tables()
    lp = am_for([3, 1, 2])
    pd.decode_native(lp, len(lp))
    pd.decode_native_nbest(lp, len(lp))
    assert pd.native_tables() is tabs
    assert len(tabs[0]) + len(tabs[5]) == got.num_arcs


@needs_gxx
def test_library_is_built_under_build_native():
    native.wfst_lib()
    path = native.library_path("wfst_decoder")
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR == native._DIR.parent.parent / "build" / "native"
    assert path.name.startswith("libwfst_decoder.")
    assert not list(native._DIR.glob("*.so"))


@pytest.fixture
def moved_build(tmp_path, monkeypatch):
    """The native package's source and build dirs moved under tmp_path."""
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(native._DIR / "wfst_decoder.cpp", src)
    monkeypatch.setattr(native, "_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    return src


@needs_gxx
def test_failed_build_raises_with_the_compiler_output(moved_build):
    (moved_build / "wfst_decoder.cpp").write_text(
        "int wfst_viterbi( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build("wfst_decoder")
    assert "error" in str(e.value)
    assert not list((moved_build.parent / "build").glob("*"))


def test_no_gxx_raises(moved_build, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build("wfst_decoder")


@needs_gxx
def test_an_edited_source_is_rebuilt(moved_build):
    first = native.build("wfst_decoder")
    src = moved_build / "wfst_decoder.cpp"
    src.write_text(src.read_text() + "\n// edited\n")
    second = native.build("wfst_decoder")
    assert first.exists() and second.exists() and first != second


@needs_gxx
def test_processes_that_build_at_once_do_not_collide(tmp_path):
    code = f"""
import pathlib, sys
sys.path.insert(0, {REPO!r})
from cat_tpu_torch import native
native.BUILD_DIR = pathlib.Path({str(tmp_path)!r})
lib = native.wfst_lib()
print(native.library_path("wfst_decoder"), lib.wfst_viterbi.restype)
"""
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({o.split()[0] for o, _ in outs}) == 1
    assert [p.name for p in tmp_path.iterdir()] == [
        native.library_path("wfst_decoder").name]
