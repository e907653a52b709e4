"""Chain-history IO and carry checkpoints.

Port of ``glabc_tpu/utils/io.py``.  :class:`ChainWriter` streams ``(C, S, d)``
segments to CSV (first row the initial theta, then one row per iteration,
``GLMCMC.py:43-47``).  Checkpoints are the port's own ``.npz`` of *named*
arrays: the JAX files pickle a jax treedef, which the port cannot read, so
:func:`save_carry` takes a flat mapping of names to arrays and
:func:`load_carry` gives it back.  The native C++ writer of ``glabc_tpu``
is not ported yet.
"""

from __future__ import annotations

import csv
import os
from typing import Mapping

import numpy as np
import torch

__all__ = ["ChainWriter", "save_carry", "load_carry", "carry_path"]


class ChainWriter:
    """One CSV per recorded chain.  ``chains=None`` writes chain 0 only (the
    reference format); ``'all'`` writes ``<stem>_chain<k>.csv`` for every
    chain; an iterable of indices writes those."""

    def __init__(self, filelocation: str, chains=None,
                 use_native: bool = False):
        if use_native:
            raise NotImplementedError(
                "the native chain writer is not ported yet (ROADMAP Queue 1, "
                "M13); use use_native=False")
        self.filelocation = filelocation
        self.chains = chains

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
        for ci in self._indices(theta0.shape[0]):
            with open(self._path(ci), "w", newline="", encoding="utf-8") as f:
                csv.writer(f).writerow(theta0[ci].ravel())

    def on_segment(self, block, start_index: int) -> None:
        """Append a ``(C, S, d)`` segment."""
        block = np.asarray(block)
        for ci in self._indices(block.shape[0]):
            with open(self._path(ci), "a", newline="", encoding="utf-8") as f:
                csv.writer(f).writerows(block[ci])

    def close(self) -> None:
        pass


def carry_path(path: str) -> str:
    """The checkpoint's file name, always ending in ``.npz``."""
    return path if path.endswith(".npz") else path + ".npz"


def save_carry(path: str, arrays: Mapping[str, object], step: int = 0) -> None:
    """Write ``arrays`` (name -> tensor, array or number) and the step
    counter, atomically (temp file, then ``os.replace``)."""
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
    np.savez(tmp, **out)
    os.replace(tmp, path)


def load_carry(path: str):
    """``(arrays, step)`` as written by :func:`save_carry`; arrays come back
    as numpy."""
    with np.load(carry_path(path), allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files if k != "__step__"}
        step = int(data["__step__"])
    return arrays, step
