"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` into its own shared library
with a plain C interface, at first use, under ``glabc_tpu_torch/_build/``.
The generic kernels (``PROGRAM_SOURCES``) are built once per tile program:
the program's header under ``csrc/programs/`` is pre-included
(``--pre-include``, with ``-DGLABC_PROGRAM`` and the program's ``-D``
defines), and the library is named by the program and a hash.  The first
load starts one ``nvcc`` for every library that is missing (with
``build_all``, every shipped pair too), all at once, and waits for them.
The hash covers the source, the shared headers (``csrc/*.cuh``), the
program's header and defines, and the flags, so an edited file builds anew
and an unchanged one is reused; ``nvcc -Xptxas -v`` output is kept beside
the library.  Nothing here runs at import time: importing the package
needs no ``nvcc``.
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
           "PROGRAM_SOURCES", "SHIPPED", "NVCC_FLAGS", "BUILD_DIR",
           "SRC_DIR"]

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
_L = ctypes.c_longlong
_P = ctypes.c_void_p

# source stem -> C signatures of its extern "C" functions
SOURCES = {
    "mixture_glmcmc": {
        "glabc_mixture_glmcmc": [_P] * 13 + [_I] * 9 + [_F] * 12 + [_U] * 4
        + [_I, _P],
        "glabc_philox4x32": [_P, _P, _I, _P],
        "glabc_mixture_register_dims": [_I],
    },
    "pool_isir": {
        "glabc_pool_isir": [_P] * 9 + [_I] * 5 + [_U] * 4 + [_I, _P],
    },
    "kde_logprob": {
        "glabc_kde_logprob": [_P] * 5 + [_I] * 4 + [_P],
        "glabc_kde_logprob_pool": [_P] * 6 + [_I] * 4 + [_P],
    },
    "shared_redraw": {
        "glabc_shared_redraw": [_P] * 12 + [_I] * 5 + [_F] * 5 + [_P],
    },
    "pool_isir_mixed": {
        "glabc_pool_isir_mixed": [_P] * 18 + [_I] * 6 + [_F] * 8
        + [_U] * 4 + [_I, _I, _P],
    },
    "glmala": {
        "glabc_glmala": [_P] * 15 + [_I] * 7 + [_F] * 18 + [_U] * 4
        + [_I, _I, _P],
    },
    "coupling_flow": {
        "glabc_coupling_flow": [_P] * 4 + [_I] * 8 + [_P],
        "glabc_coupling_flow_max_sub": [_I] * 4,
    },
    "coupling_flow_bf16": {
        "glabc_coupling_flow_bf16": [_P] * 4 + [_I] * 6 + [_P],
        "glabc_coupling_flow_bf16_max_tiles": [_I, _I],
        "glabc_coupling_flow_bf16_layer_bytes": [_I, _I],
    },
    "coupling_flow_wide": {
        "glabc_coupling_flow_wide": [_P] * 4 + [_I] * 8 + [_P],
        "glabc_coupling_flow_wide_layer_floats": [_I] * 3,
    },
    "radix_select": {
        "glabc_radix_select_hist": [_P, _L, _P, _P, _I, _I, _P],
        "glabc_radix_select_pick": [_P, _P, _I, _P, _P],
    },
}

# sources built per tile program -> the C signatures a program build adds
# (pool_isir_mixed keeps its built-in Mixture function beside them)
PROGRAM_SOURCES = {
    "generic_glmcmc": {
        "glabc_generic_glmcmc": [_P] * 12 + [_I] * 11 + [_F]
        + [_U] * 4 + [_I, _P],
    },
    "generic_glmala": {
        "glabc_generic_glmala": [_P] * 15 + [_I] * 11 + [_F] * 7
        + [_U] * 4 + [_I, _P],
    },
    "pool_isir_mixed": {
        "glabc_pool_isir_mixed_program": [_P] * 18 + [_I] * 9 + [_F]
        + [_U] * 4 + [_I, _I, _P],
    },
}

# a program's build key: (header under csrc/, ((define, value), ...))
_MIXTURE2 = ("programs/mixture.cuh", (("GLABC_MIXTURE_D", 2),))
_MA2 = ("programs/ma2.cuh", ())
# the (source, program) pairs build_all() builds besides every source
SHIPPED = (("generic_glmcmc", _MIXTURE2), ("generic_glmcmc", _MA2),
           ("generic_glmala", _MIXTURE2), ("generic_glmala", _MA2),
           ("pool_isir_mixed", _MA2))


def _key(program):
    """A program's build key, from a TileProgram or the key itself."""
    if program is None:
        return None
    key = getattr(program, "build_key", program)
    header, defines = key
    return str(header), tuple((str(k), int(v)) for k, v in defines)


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


def _program_flags(key) -> list:
    if key is None:
        return []
    header, defines = key
    return (["-I", str(SRC_DIR), "--pre-include", str(SRC_DIR / header),
             "-DGLABC_PROGRAM"] + [f"-D{k}={v}" for k, v in defines])


def lib_path(stem: str = "mixture_glmcmc", program=None) -> Path:
    """Where the library built from ``csrc/<stem>.cu`` (for ``program``, a
    TileProgram or its build key, where the source takes one) lives."""
    key = _key(program)
    known = SOURCES if key is None else PROGRAM_SOURCES
    if stem not in known:
        raise ValueError(f"no CUDA source {stem!r}"
                         f"{'' if key is None else ' taking a program'}; "
                         f"known: {sorted(known)}")
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS + _program_flags(key)).encode())
    files = [SRC_DIR / f"{stem}.cu"] + sorted(SRC_DIR.glob("*.cuh"))
    if key is not None:
        files.append(SRC_DIR / key[0])
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    tag = ""
    if key is not None:
        tag = "-" + "-".join([Path(key[0]).stem]
                             + [f"{k}{v}" for k, v in key[1]])
    return BUILD_DIR / f"lib{stem}{tag}_{h.hexdigest()[:16]}.so"


def build_all(extra=()) -> None:
    """Compile every source, every shipped (source, program) pair and the
    ``extra`` pairs whose library is missing, one ``nvcc`` process each,
    all started together; raise if any fails."""
    pairs = [(s, None) for s in SOURCES]
    pairs += [(s, _key(p)) for s, p in (*SHIPPED, *extra)]
    todo, seen = [], set()
    for stem, key in pairs:
        out = lib_path(stem, key)
        if out not in seen and not out.exists():
            seen.add(out)
            todo.append((stem, key))
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for stem, key in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *_program_flags(key), "-o", tmp,
             str(SRC_DIR / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((stem, key, tmp, proc))
    failed = []
    for stem, key, tmp, proc in jobs:
        out_text, _ = proc.communicate()
        out = lib_path(stem, key)
        out.with_suffix(".log").write_text(out_text)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}) for {out.name}:"
                          f"\n{out_text}")
        else:
            os.replace(tmp, out)   # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(stem: str = "mixture_glmcmc", program=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (built for ``program``, a
    TileProgram or its build key, where given), built first if needed
    (with every other missing one), with each function's
    ``argtypes``/``restype`` declared."""
    return _load(stem, _key(program))


@functools.cache
def _load(stem, key) -> ctypes.CDLL:
    out = lib_path(stem, key)
    if not out.exists():
        build_all(extra=() if key is None else ((stem, key),))
    lib = ctypes.CDLL(str(out))
    sigs = dict(SOURCES.get(stem, {}))
    if key is not None:
        sigs.update(PROGRAM_SOURCES[stem])
    for fn, argtypes in sigs.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_log(stem: str = "mixture_glmcmc", program=None) -> str:
    """What ``nvcc -Xptxas -v`` printed for the library (registers, spills),
    or '' when it was built by another process before this one looked."""
    log = lib_path(stem, program).with_suffix(".log")
    return log.read_text() if log.exists() else ""
