"""Host-side C++ of the port, loaded with ctypes: the WFST Viterbi core
(`wfst_decoder.cpp`, the port's own copy of the JAX package's).

`wfst_lib()` compiles the source with g++ at its first call into
`build/native/` at the repo root (the file name carries a hash of the
source and flags, so an edited source is rebuilt), writing a temporary
name first and renaming it, so processes that build at once do not
collide. Nothing is built at import. A failed build or load raises with
g++'s output: there is no silent fallback to the Python decoder.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_wfst_lib = None


def library_path(name: str) -> Path:
    h = hashlib.sha256((_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """The shared library of `<name>.cpp`, compiled if it is missing."""
    out = library_path(name)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: cat_tpu_torch/native/{name}.cpp "
                           "is compiled with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(_DIR / f"{name}.cpp"), "-o",
                           str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {name}.cpp (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def wfst_lib():
    """ctypes handle to the native WFST decoder (built on demand)."""
    global _wfst_lib
    with _lock:
        if _wfst_lib is not None:
            return _wfst_lib
        lib = ctypes.CDLL(str(build("wfst_decoder")))
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        common = [
            i32p, i32p, i32p, i32p, f32p, ctypes.c_int32,   # emit arcs
            i32p, i32p, i32p, f32p, ctypes.c_int32,          # eps arcs
            ctypes.c_int32, ctypes.c_int32, f32p,            # states
            f32p, ctypes.c_int32, ctypes.c_int32,            # logprobs
            ctypes.c_float, ctypes.c_int32, ctypes.c_float,  # beam...
        ]
        lib.wfst_viterbi.restype = ctypes.c_int
        lib.wfst_viterbi.argtypes = common + [
            i32p, ctypes.c_int32, f32p,                      # outputs
        ]
        lib.wfst_nbest.restype = ctypes.c_int
        lib.wfst_nbest.argtypes = common + [
            ctypes.c_int32,                                  # K
            i32p, i32p, f32p, ctypes.c_int32,                # outputs
        ]
        _wfst_lib = lib
        return lib
