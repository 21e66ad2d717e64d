"""The C entries of the port's CUDA sources against their wrappers' specs.

`cat_tpu_torch._build.load` sets each entry's ctypes `argtypes` from the
spec its wrapper passes, (pointers, ints, floats) and then the stream, and
its `restype` to int. ctypes trusts that spec: a pointer passed where the
C function takes an int, or one argument too few, shows only on the card,
as a crash or as garbage. This test reads every `extern "C"` entry of
`cat_tpu_torch/csrc/*.cu` and every `_build.load(<library>, <spec>)` of
`cat_tpu_torch/ops/*.py`, and holds one against the other. It needs no
nvcc and no card.
"""
import importlib
import re
from pathlib import Path

import pytest

from cat_tpu_torch import _build

OPS = Path(_build.__file__).resolve().parent / "ops"
ENTRY = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)')
LOAD = re.compile(r'_build\.load\(\s*"(\w+)"\s*,\s*(\w+)\s*\)')


def _c_entries():
    """{entry: (library, return type, kinds)}, kinds one of p, i, f per
    parameter (pointer, int, float)."""
    out = {}
    for cu in sorted(_build.CSRC.glob("*.cu")):
        for ret, name, params in ENTRY.findall(cu.read_text()):
            kinds = ""
            for p in params.split(","):
                p = " ".join(p.split())
                kinds += ("p" if "*" in p else "i" if p.startswith("int ")
                          else "f" if p.startswith("float ") else "?")
            out[name] = (cu.stem, ret, kinds)
    return out


def _specs():
    """{entry: (library, (pointers, ints, floats), where)} from every
    `_build.load` call of the ops modules."""
    out = {}
    for py in sorted(OPS.glob("*.py")):
        mod = importlib.import_module(f"cat_tpu_torch.ops.{py.stem}")
        for lib, var in LOAD.findall(py.read_text()):
            for name, counts in getattr(mod, var).items():
                out[name] = (lib, tuple(counts), f"{py.name}:{var}")
    return out


C_ENTRIES = _c_entries()


def test_the_sources_have_entries():
    assert len(C_ENTRIES) >= 16
    assert set(_build.SOURCES) == {lib for lib, _, _ in C_ENTRIES.values()}


@pytest.mark.parametrize("name", sorted(C_ENTRIES))
def test_entry_matches_its_wrapper_spec(name):
    lib, ret, kinds = C_ENTRIES[name]
    specs = _specs()
    assert name in specs, f"no wrapper loads the C entry {name} ({lib}.cu)"
    spec_lib, (n_ptr, n_int, n_float), where = specs[name]
    assert spec_lib == lib, f"{where} loads {name} from {spec_lib}, not {lib}"
    assert ret == "int", f"{name} returns {ret}; ctypes reads an int"
    want = "p" * n_ptr + "i" * n_int + "f" * n_float + "p"
    assert kinds == want, (f"{lib}.cu {name} takes {kinds}, {where} passes "
                           f"{want} (p pointer, i int, f float; the stream "
                           f"last)")


def test_every_spec_names_a_c_entry():
    for name, (lib, _, where) in _specs().items():
        assert lib in _build.SOURCES, f"{where}: no source {lib}.cu"
        assert C_ENTRIES.get(name, (None,))[0] == lib, \
            f"{where} names {name}, which {lib}.cu does not define"
