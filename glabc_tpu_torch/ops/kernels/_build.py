"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` into its own shared library
with a plain C interface, at first use, under ``glabc_tpu_torch/_build/``.
The first load starts one ``nvcc`` for every source whose library is
missing, all at once, and waits for them.  A library is named by a hash of
its source, the shared headers and the flags, so an edited source builds
anew and an unchanged one is reused; ``nvcc -Xptxas -v`` output is kept
beside it.  Nothing here runs at import time: importing the package needs
no ``nvcc``.
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

__all__ = ["load_library", "build_all", "build_log", "lib_path", "SOURCES",
           "NVCC_FLAGS", "BUILD_DIR", "SRC_DIR"]

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math: accurate logf/expf/sinf/cosf/sqrtf and IEEE division.
# --fmad=false keeps every multiply and add rounded on its own, as the plain
# torch versions compute them, so kernels and plain versions agree bitwise
# up to the transcendental functions and the order of long sums.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

_F = ctypes.c_float
_I = ctypes.c_int
_U = ctypes.c_uint
_P = ctypes.c_void_p

# source stem -> C signatures of its extern "C" functions
SOURCES = {
    "mixture_glmcmc": {
        "glabc_mixture_glmcmc": [_P] * 13 + [_I] * 9 + [_F] * 12 + [_U] * 3
        + [_I, _P],
        "glabc_philox4x32": [_P, _P, _I, _P],
        "glabc_mixture_register_dims": [_I],
    },
    "pool_isir": {
        "glabc_pool_isir": [_P] * 9 + [_I] * 5 + [_U] * 3 + [_I, _P],
    },
    "kde_logprob": {
        "glabc_kde_logprob": [_P] * 5 + [_I] * 4 + [_P],
    },
    "pool_isir_mixed": {
        "glabc_pool_isir_mixed": [_P] * 18 + [_I] * 6 + [_F] * 8
        + [_U] * 3 + [_I, _P],
    },
    "glmala": {
        "glabc_glmala": [_P] * 15 + [_I] * 7 + [_F] * 18 + [_U] * 3
        + [_I, _P],
    },
    "coupling_flow": {
        "glabc_coupling_flow": [_P] * 9 + [_I] * 6 + [_P],
        "glabc_coupling_flow_max_rows": [_I, _I],
    },
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


def lib_path(stem: str = "mixture_glmcmc") -> Path:
    """Where the library built from ``csrc/<stem>.cu`` lives."""
    if stem not in SOURCES:
        raise ValueError(f"no CUDA source {stem!r}; known: {sorted(SOURCES)}")
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in [SRC_DIR / f"{stem}.cu"] + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Compile every source whose library is missing, one ``nvcc`` process
    each, all started together; raise if any fails."""
    todo = [s for s in SOURCES if not lib_path(s).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for stem in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((stem, tmp, proc))
    failed = []
    for stem, tmp, proc in jobs:
        out_text, _ = proc.communicate()
        out = lib_path(stem)
        out.with_suffix(".log").write_text(out_text)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}) for {out.name}:"
                          f"\n{out_text}")
        else:
            os.replace(tmp, out)   # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load_library(stem: str = "mixture_glmcmc") -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed (with
    every other missing one), with each function's ``argtypes``/``restype``
    declared."""
    out = lib_path(stem)
    if not out.exists():
        build_all()
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in SOURCES[stem].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_log(stem: str = "mixture_glmcmc") -> str:
    """What ``nvcc -Xptxas -v`` printed for the library (registers, spills),
    or '' when it was built by another process before this one looked."""
    log = lib_path(stem).with_suffix(".log")
    return log.read_text() if log.exists() else ""
