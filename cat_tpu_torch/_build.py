"""Build and load the port's CUDA kernels.

Every `cat_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` into its own
shared library with a plain C interface under `build/kernels/` (at the
repo root), at the first CUDA call, and loaded with `ctypes`. Nothing is
built when the package is imported, and only the sources in this checkout
are compiled. All missing libraries are compiled at once, one `nvcc`
process per source. A library's file name carries a hash of its sources
and flags, so an edited source is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("ffn_fwd", "ffn_bwd", "glu_in", "bn_out", "relpos_attention_fwd",
           "relpos_attention_bwd", "dropout", "ctc", "crf_dense", "rnnt",
           "ffn_f32", "relpos_attention_f32", "conv_module_f32")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of cat_tpu_torch "
                       "are built with the CUDA toolkit's nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every kernel library that is missing. Returns nvcc's output
    (registers, shared memory and spills of each kernel) by source name,
    for the sources it compiled. Raises with that output if any source
    fails to compile."""
    with _lock:
        todo = [(n, library_path(n)) for n in SOURCES
                if not library_path(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, out in todo:
            tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = {}, []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return logs


def load(name: str, entries: dict) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if missing.

    `entries` maps each C entry to its argument counts (pointers, ints,
    floats); every entry takes those, then the stream, and returns a CUDA
    error code."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                for fn_name, (n_ptr, n_int, n_float) in entries.items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = ([ctypes.c_void_p] * n_ptr
                                   + [ctypes.c_int] * n_int
                                   + [ctypes.c_float] * n_float
                                   + [ctypes.c_void_p])
                    fn.restype = ctypes.c_int
                _libs[name] = lib
    return lib


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
