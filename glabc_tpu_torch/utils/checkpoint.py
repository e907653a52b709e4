"""Versioned checkpoints written by one background thread.

Port of ``glabc_tpu/utils/checkpoint.py``.  The JAX package hands the
writes to orbax; the port has no orbax, so one writer thread saves each
step as the port's ``.npz`` of named arrays (:func:`~glabc_tpu_torch.
utils.io.save_carry`: a temporary file renamed into place, so that an
interrupted write leaves no partial file), one file a step, and removes
all but the newest ``max_to_keep``.  :meth:`CheckpointManager.save` copies
the carry to the host before it returns, so the caller may go on changing
its tensors while the file is written.

A carry is a mapping of names to tensors, arrays or numbers, or an object
with ``to_arrays()`` (the samplers' carries, e.g. ``ChainCarry``);
:meth:`CheckpointManager.restore` gives the mapping back as numpy, from
which ``ChainCarry.from_arrays`` rebuilds the carry.

Under ``mesh=`` (a 1-D ``DeviceMesh``, one process per GPU) each rank
writes its own file a step, ``ckpt_<step>.rank<r>.npz``, with the world
size in it, as the samplers' own checkpoints do; a restore on another
world size raises ``ValueError``.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .io import load_carry, save_carry

__all__ = ["CheckpointManager"]

_ANY = re.compile(r"^ckpt_(\d+)(?:\.rank(\d+))?\.npz$")


def _host_copy(x) -> np.ndarray:
    """``x`` as a numpy array that shares no memory with the caller's."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


class CheckpointManager:
    """Versioned checkpoints of a carry.

    >>> mgr = CheckpointManager("ckpts/run1", max_to_keep=3)
    >>> mgr.save(step, carry)            # returns once copied to the host
    >>> arrays, step = mgr.restore()     # latest, or restore(step=...)
    >>> mgr.close()                      # waits for the writes in flight

    ``max_to_keep=None`` keeps every step.
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 mesh=None):
        if max_to_keep is not None and int(max_to_keep) < 1:
            raise ValueError(f"max_to_keep must be >= 1 or None, got "
                             f"{max_to_keep}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = None if max_to_keep is None else int(max_to_keep)
        self._mesh = mesh
        if mesh is None:
            self._rank, self._world = None, 1
        else:
            from ..parallel.mesh import check_mesh

            self._rank, self._world, _ = check_mesh(mesh)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="checkpoint")
        self._pending = []

    def _path(self, step: int) -> str:
        rank = "" if self._rank is None else f".rank{self._rank}"
        return os.path.join(self.directory, f"ckpt_{int(step)}{rank}.npz")

    def _steps(self, own: bool) -> list:
        """The steps of this rank's files (``own``), or of the files that
        another world size wrote: ``.rank<r>`` files without a mesh, and
        under one the files without a rank or of a rank beyond it."""
        out = set()
        for name in os.listdir(self.directory):
            m = _ANY.match(name)
            if m is None:
                continue
            rank = None if m.group(2) is None else int(m.group(2))
            if self._rank is None:
                foreign = rank is not None
            else:
                foreign = rank is None or rank >= self._world
            if own and rank == self._rank or not own and foreign:
                out.add(int(m.group(1)))
        return sorted(out)

    # ------------------------------------------------------------ save
    def save(self, step: int, carry, wait: bool = False) -> None:
        """Checkpoint ``carry`` at ``step``.  The arrays are copied to the
        host here; the file is written on the writer thread (``wait=True``,
        :meth:`wait` or :meth:`close` block until it is on disk and raise
        the error of a write that failed)."""
        arrays = carry.to_arrays() if hasattr(carry, "to_arrays") else carry
        snapshot = {k: _host_copy(v) for k, v in arrays.items()}
        snapshot["meta.world_size"] = np.asarray(self._world)
        self._pending.append(
            self._pool.submit(self._write, int(step), snapshot))
        if wait:
            self.wait()

    def _write(self, step: int, arrays: dict) -> None:
        save_carry(self._path(step), arrays, step)
        if self.max_to_keep is not None:
            for old in self._steps(own=True)[:-self.max_to_keep]:
                os.remove(self._path(old))

    # --------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None):
        """``(arrays, step)`` of ``step`` (default: :meth:`latest_step`),
        after the writes in flight.  Raises ``FileNotFoundError`` when there
        is no such checkpoint and ``ValueError`` when it was saved on
        another world size."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None or not os.path.exists(self._path(step)):
            foreign = self._steps(own=False)
            if foreign if step is None else int(step) in foreign:
                raise ValueError(
                    f"the checkpoints under {self.directory} were saved on "
                    f"another world size than this run's {self._world}; "
                    "restore on the world size that saved them")
            raise FileNotFoundError(
                f"no checkpoint{'' if step is None else f' of step {step}'}"
                f" under {self.directory}")
        arrays, saved_step = load_carry(self._path(step))
        saved = int(arrays.pop("meta.world_size", 1))
        if saved != self._world:
            raise ValueError(f"checkpoint of step {step} was saved on world "
                             f"size {saved}, this run has {self._world}")
        return arrays, saved_step

    # ------------------------------------------------------------ misc
    def all_steps(self) -> list:
        """The steps of this rank's files, oldest first, after the writes
        in flight."""
        self.wait()
        return self._steps(own=True)

    def latest_step(self) -> Optional[int]:
        """The newest step, or None.  Under a mesh it is the newest step
        that every rank holds (a collective: every rank calls it), so that
        after a crash between two ranks' writes all ranks restore the same
        step."""
        steps = self.all_steps()
        latest = steps[-1] if steps else -1
        if self._mesh is not None:
            import torch.distributed as dist

            t = torch.tensor([latest], dtype=torch.int64,
                             device=self._mesh.device_type)
            dist.all_reduce(t, op=dist.ReduceOp.MIN,
                            group=self._mesh.get_group())
            latest = int(t.item())
            if latest >= 0 and latest not in steps:
                raise RuntimeError(
                    f"step {latest}, the newest every rank holds, is no "
                    f"longer under {self.directory} for this rank "
                    f"(max_to_keep={self.max_to_keep})")
        return None if latest < 0 else latest

    def wait(self) -> None:
        """Block until every save so far is on disk; raise the first
        error among them."""
        pending, self._pending = self._pending, []
        errors = [e for e in (f.exception() for f in pending) if e]
        if errors:
            raise errors[0]

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
