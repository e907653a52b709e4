"""Build the port's CUDA source with ``nvcc`` and load it with ``ctypes``.

``csrc/mixture_glmcmc.cu`` is compiled for ``sm_90a`` into a shared library
with a plain C interface, at first use, under ``glabc_tpu_torch/_build/``.
The library is named by a hash of the sources and flags, so an edited source
builds anew and an unchanged one is reused.  Nothing here runs at import
time: importing the package needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_library", "build_log", "lib_path", "NVCC_FLAGS",
           "BUILD_DIR", "SRC_DIR"]

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_SOURCE = SRC_DIR / "mixture_glmcmc.cu"

# No --use_fast_math: accurate logf/sinf/cosf/sqrtf and IEEE division.
# --fmad=false keeps every multiply and add rounded on its own, as the plain
# torch version computes them, so kernel and plain version agree bitwise up
# to the transcendental functions.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

_F = ctypes.c_float
_I = ctypes.c_int
_U = ctypes.c_uint
_P = ctypes.c_void_p

# C signatures of the library's extern "C" functions
_SIGNATURES = {
    "glabc_mixture_glmcmc": [_P] * 13 + [_I] * 9 + [_F] * 12 + [_U] * 3
    + [_I, _P],
    "glabc_philox4x32": [_P, _P, _I, _P],
    "glabc_mixture_register_dims": [_I],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build on a machine with the CUDA "
        "toolkit (set PATH to include its bin directory)")


def lib_path() -> Path:
    """Where the library built from the sources lives."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{_SOURCE.stem}_{h.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """The loaded library, built first if needed, with every function's
    ``argtypes``/``restype`` declared."""
    out = lib_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        out.with_suffix(".log").write_text(proc.stdout)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                               f"{out.name}:\n{proc.stdout}")
        os.replace(tmp, out)   # atomic: concurrent builders agree
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_log() -> str:
    """What ``nvcc -Xptxas -v`` printed for the library (registers, spills),
    or '' when it was built by another process before this one looked."""
    log = lib_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""
