"""ctypes binding and build of the native asynchronous chain writer.

Port of ``glabc_tpu/native/writer.py``.  ``chain_writer.cpp`` is compiled
with ``g++`` at first use into ``glabc_tpu_torch/_build/``, under a name
that holds a hash of the source and the flags: ``g++`` writes a temporary
file in that directory and ``os.replace`` renames it into place, so that
processes building at once (test workers) never load a half-written
library, and an edited source builds anew.  Nothing is built or loaded
at import time.
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

import numpy as np

__all__ = ["NativeChainWriter", "native_available", "build", "lib_path",
           "GXX_FLAGS"]

SRC = Path(__file__).resolve().with_name("chain_writer.cpp")
BUILD_DIR = SRC.parents[1] / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_I32, _I64 = ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {   # name -> (restype, argtypes)
    "cw_open": (_I64, [ctypes.c_char_p, _I64, _I32]),
    "cw_write": (_I32, [_I64, ctypes.POINTER(ctypes.c_float), _I64]),
    "cw_flush": (_I32, [_I64]),
    "cw_queue_depth": (_I64, [_I64]),
    "cw_close": (_I32, [_I64]),
}


def lib_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libchainwriter_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiled first when it is missing.  Raises
    ``FileNotFoundError`` without ``g++`` and
    ``subprocess.CalledProcessError`` when it fails; no partial file is
    left either way."""
    out = lib_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(SRC), "-lpthread"],
                       check=True, capture_output=True)
        os.replace(tmp, out)   # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def _load():
    """The loaded library with its signatures declared, or None when it
    cannot be built or loaded (the callers then use the Python writer)."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.CalledProcessError):
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def native_available() -> bool:
    return _load() is not None


class NativeChainWriter:
    """Asynchronous chain sink: ``write(block)`` copies the block and
    returns; a C++ thread formats it (CSV text, ``%.9g``, or raw float32)
    and appends it to the file.  The native backend of
    :class:`glabc_tpu_torch.utils.io.ChainWriter`."""

    def __init__(self, path: str, dim: int, binary: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("native chain writer unavailable (no g++?)")
        self._lib = lib
        self._dim = int(dim)
        open(path, "wb").close()   # truncate; the C++ side appends
        self._h = lib.cw_open(os.fsencode(path), self._dim,
                              1 if binary else 0)
        if self._h < 0:
            raise OSError(f"cw_open failed for {path}")

    def write(self, block) -> None:
        """``block``: ``(steps, dim)``, copied to contiguous float32."""
        block = np.ascontiguousarray(block, dtype=np.float32)
        if block.ndim != 2 or block.shape[1] != self._dim:
            raise ValueError(f"block must be (steps, {self._dim}), got "
                             f"{block.shape}")
        ptr = block.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if self._lib.cw_write(self._h, ptr, block.shape[0]) != 0:
            raise OSError("cw_write failed")

    def queue_depth(self) -> int:
        return int(self._lib.cw_queue_depth(self._h))

    def flush(self) -> None:
        self._lib.cw_flush(self._h)

    def close(self) -> None:
        if self._h >= 0:
            self._lib.cw_close(self._h)
            self._h = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_h", -1) >= 0:
            self.close()
