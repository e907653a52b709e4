"""Chain-history IO and carry checkpoints.

Port of ``glabc_tpu/utils/io.py``.  :class:`ChainWriter` streams ``(C, S, d)``
segments to CSV (first row the initial theta, then one row per iteration,
``GLMCMC.py:43-47``), or with ``use_native=True`` through the C++
asynchronous writer (:mod:`glabc_tpu_torch.native`): the chain-0 CSV, or
with ``chains='all'`` one binary file of every chain that
:func:`read_binary_chains` reads back.  The files are byte for byte those
of the JAX package's writers.  Checkpoints are the port's own ``.npz`` of
*named* arrays: the JAX files pickle a jax treedef, which the port cannot
read, so :func:`save_carry` takes a flat mapping of names to arrays and
:func:`load_carry` gives it back.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Mapping

import numpy as np
import torch

__all__ = ["ChainWriter", "read_binary_chains", "save_carry", "load_carry",
           "carry_path"]


class _NativeMultiChainSink:
    """Every chain into ONE binary file through the C++ writer: raw float32
    ``(C, S, d)`` blocks, chain-major, with the segment lengths in a
    ``<path>.meta.json`` sidecar for :func:`read_binary_chains`.  One file
    and one writer thread whatever the chain count."""

    def __init__(self, path: str, num_chains: int, dim: int):
        from ..native import NativeChainWriter

        self.path = path
        self.num_chains = int(num_chains)
        self.dim = int(dim)
        self._segments = []
        self._w = NativeChainWriter(path, self.dim, binary=True)

    def write_block(self, block: np.ndarray) -> None:
        """``block``: ``(C, S, d)``."""
        C, S, d = block.shape
        if (C, d) != (self.num_chains, self.dim):
            raise ValueError(f"block of {C} chains x d={d}, the file holds "
                             f"{self.num_chains} x d={self.dim}")
        self._w.write(np.ascontiguousarray(block, np.float32).reshape(-1, d))
        self._segments.append(int(S))
        # the sidecar is rewritten after every block, so that a crash
        # mid-run leaves the history readable; the payload may trail it by
        # the block in flight, which read_binary_chains drops
        self._write_sidecar()

    def _write_sidecar(self) -> None:
        meta = {"num_chains": self.num_chains, "dim": self.dim,
                "dtype": "float32", "segments": self._segments}
        tmp = self.path + ".meta.json.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(meta, f)
        os.replace(tmp, self.path + ".meta.json")

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None
            self._write_sidecar()


def read_binary_chains(path: str) -> np.ndarray:
    """The ``(C, T, d)`` history written by the native all-chain sink
    (``ChainWriter(..., chains='all', use_native=True)``).  Only whole
    segments count: a segment the sidecar lists but the file does not
    hold in full (a crash mid-run) is dropped."""
    with open(path + ".meta.json", encoding="utf-8") as f:
        meta = json.load(f)
    C, d = meta["num_chains"], meta["dim"]
    raw = np.fromfile(path, dtype=np.float32)
    blocks, off = [], 0
    for S in meta["segments"]:
        n = C * S * d
        if off + n > raw.size:
            break
        blocks.append(raw[off:off + n].reshape(C, S, d))
        off += n
    if not blocks:
        raise ValueError(f"{path} holds no complete segment")
    return np.concatenate(blocks, axis=1)


class ChainWriter:
    """One CSV per recorded chain.  ``chains=None`` writes chain 0 only (the
    reference format); ``'all'`` writes ``<stem>_chain<k>.csv`` for every
    chain; an iterable of indices writes those.

    ``use_native=True`` hands the IO to the C++ writer: with
    ``chains=None`` the chain-0 CSV (``%.9g``, which reads back to the same
    float32), with ``chains='all'`` one binary file of every chain plus a
    ``.meta.json`` sidecar (:func:`read_binary_chains`).  Where the library
    cannot be built (no ``g++``), or for an index list, the Python writer
    runs instead, as in the JAX package."""

    def __init__(self, filelocation: str, chains=None,
                 use_native: bool = False):
        self.filelocation = filelocation
        self.chains = chains
        self._native = None
        self._use_native = False
        if use_native and (chains is None or chains == "all"):
            from ..native import native_available

            self._use_native = native_available()

    def _path(self, chain_idx: int) -> str:
        if self.chains is None:
            return self.filelocation
        stem, ext = os.path.splitext(self.filelocation)
        return f"{stem}_chain{chain_idx}{ext or '.csv'}"

    def _indices(self, num_chains: int):
        if self.chains is None:
            return [0]
        if self.chains == "all":
            return list(range(num_chains))
        return list(self.chains)

    def write_initial(self, theta0) -> None:
        """Write the initial theta row(s); ``theta0`` is ``(C, d)``."""
        theta0 = np.atleast_2d(np.asarray(theta0))
        if self._use_native:
            from ..native import NativeChainWriter

            theta0 = theta0.astype(np.float32)
            if self.chains == "all":
                self._native = _NativeMultiChainSink(
                    self.filelocation, theta0.shape[0], theta0.shape[-1])
                self._native.write_block(theta0[:, None, :])
            else:
                self._native = NativeChainWriter(self.filelocation,
                                                 theta0.shape[-1])
                self._native.write(theta0[:1])
            return
        for ci in self._indices(theta0.shape[0]):
            with open(self._path(ci), "w", newline="", encoding="utf-8") as f:
                csv.writer(f).writerow(theta0[ci].ravel())

    def on_segment(self, block, start_index: int) -> None:
        """Append a ``(C, S, d)`` segment."""
        if self._use_native:
            block = np.asarray(block, dtype=np.float32)
            if self.chains == "all":
                self._native.write_block(block)
            else:
                self._native.write(block[0])
            return
        block = np.asarray(block)
        for ci in self._indices(block.shape[0]):
            with open(self._path(ci), "a", newline="", encoding="utf-8") as f:
                csv.writer(f).writerows(block[ci])

    def close(self) -> None:
        """Drain and close the native writer (a no-op for the Python one,
        which closes each file after each write)."""
        if self._native is not None:
            self._native.close()
            self._native = None


def carry_path(path: str) -> str:
    """The checkpoint's file name, always ending in ``.npz``."""
    return path if path.endswith(".npz") else path + ".npz"


def save_carry(path: str, arrays: Mapping[str, object], step: int = 0) -> None:
    """Write ``arrays`` (name -> tensor, array or number) and the step
    counter, atomically (temp file, then ``os.replace``): an interrupted
    write leaves the previous file as it was and no partial one."""
    path = carry_path(path)
    out = {}
    for name, x in arrays.items():
        if name == "__step__":
            raise ValueError("'__step__' is reserved")
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        out[name] = np.asarray(x)
    out["__step__"] = np.asarray(step)
    tmp = path + ".tmp.npz"
    try:
        np.savez(tmp, **out)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):   # an interrupted write leaves no file
            os.unlink(tmp)


def load_carry(path: str):
    """``(arrays, step)`` as written by :func:`save_carry`; arrays come back
    as numpy."""
    with np.load(carry_path(path), allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files if k != "__step__"}
        step = int(data["__step__"])
    return arrays, step
