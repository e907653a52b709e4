"""The run skeleton of the fused drivers: kernel seed, checkpoints, move
counters, history copy and result, and their copies to the host.

Port of ``glabc_tpu/samplers/_fused_io.py``.  Every fused driver runs its
kernel in launches around a :class:`FusedRun`, which owns what the drivers
share; the driver keeps its kernel, its state, its epoch and what it adds
to the checkpoint.  The loop state is saved as the port's own ``.npz`` of
named arrays.

Alignment rule: the kernel always runs ``steps_per_call`` transitions, so
after a ragged final segment the carry is ahead of the recorded history.
Only aligned segments are checkpointed; a resume continues from the last
aligned point and replays the ragged tail bitwise, since every draw is a
function of (seed, chain, absolute step).

The adaptive samplers (AGLMCMC, GLMCMC-NF) interleave segments with
adaptation epochs.  Their checkpoints hold the loop state before the epoch
that follows an aligned segment; a resumed run does that epoch first (the
generator state is saved with it, so the epoch replays bitwise) and goes on
with no history overlap.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.problems import initial_chains
from ..utils.io import carry_path, load_carry, save_carry
from ..utils.profiling import annotate
from .base import MoveCounts

__all__ = ["to_host", "FusedRun", "save_epoch_ckpt", "restore_epoch_ckpt"]

_COUNTERS = ("g_att", "g_acc", "l_acc")


def to_host(x: torch.Tensor) -> np.ndarray:
    """``x`` as a numpy array on the host; the copy is a ``glabc.io.d2h``
    span that counts its bytes."""
    with annotate("glabc.io.d2h", x.numel() * x.element_size()):
        return x.cpu().numpy()


def _check_meta(arrays, expect_meta):
    """Raise ``ValueError`` when the saved configuration differs from
    ``expect_meta``: the saved tensors would be read in the wrong shapes."""
    mismatches = {}
    for k, v in (expect_meta or {}).items():
        saved = arrays.get(f"meta.{k}")
        if saved is None and k == "world_size":
            saved = np.asarray(1)   # saved before runs were sharded
        if saved is None or saved.item() != v:
            mismatches[k] = (None if saved is None else saved.item(), v)
    if mismatches:
        raise ValueError(
            "checkpoint configuration mismatch (saved vs current): "
            f"{mismatches}; delete the checkpoint or restore the original "
            "configuration")


def save_epoch_ckpt(path, state, done, take, seg_len, meta=None):
    """Snapshot a sampler's loop state (a mapping of names to tensors,
    arrays or numbers) after an aligned segment (``take == seg_len``; a
    ragged final segment is not saved)."""
    if take == seg_len:
        _save(path, state, done, meta)


def _save(path, state, done, meta):
    arrays = dict(state)
    for k, v in (meta or {}).items():
        arrays[f"meta.{k}"] = v
    save_carry(path, arrays, step=done)


def restore_epoch_ckpt(path, expect_meta=None):
    """``(arrays, done)`` as saved by :func:`save_epoch_ckpt` (numpy), or
    ``None`` when there is no checkpoint; validates ``expect_meta``."""
    if not os.path.exists(carry_path(path)):
        return None
    arrays, done = load_carry(path)
    _check_meta(arrays, expect_meta)
    return arrays, int(done)


class _AsyncBlocks:
    """Deferred device-to-host history copy.  ``add`` cuts a launch's
    history to the rows kept (``thin``: iterations ``i`` with ``i % thin ==
    0``, counted across launches), lays it out as ``(C, rows, d)``
    (``layout``) and converts it (``dtype``) on the card, then starts a
    non-blocking copy into pinned host memory, so the card runs the next
    launch while this one's history streams out.  :meth:`blocks` waits for
    the copies and returns float32 numpy blocks.  ``gather`` (a
    ``ChainShard``'s) joins every rank's chains on the card before the
    copy.  Each block is a ``glabc.io.d2h`` span with its bytes."""

    def __init__(self, layout, gather, thin: int = 1, dtype=None):
        self._layout, self._gather = layout, gather
        self._thin = max(1, int(thin))
        self._dtype = dtype
        self._host = []
        self._event = None

    def add(self, hist: torch.Tensor, take: int, done: int = 0) -> None:
        """Row ``r`` of ``hist`` is global iteration ``done + 1 + r``."""
        t = self._thin
        r0 = (-(done + 1)) % t
        if r0 >= take:
            return
        dev = self._layout(hist[r0:take:t])
        if self._dtype is not None:
            dev = dev.to(self._dtype)
        dev = self._gather(dev.contiguous())
        with annotate("glabc.io.d2h", dev.numel() * dev.element_size()):
            if dev.is_cuda:
                host = torch.empty(dev.shape, dtype=dev.dtype,
                                   pin_memory=True)
                host.copy_(dev, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record()
            else:
                host = dev
        self._host.append(host)

    def blocks(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        return [h.to(torch.float32).numpy() for h in self._host]


def _history_dtype(thin: int, history_dtype, on_segment):
    """The history copy's torch dtype, or None for float32; thinning and
    bfloat16 compress the asynchronous copy and so exclude ``on_segment``,
    which takes synchronous full-resolution float32 blocks.  bfloat16
    histories come back as float32 arrays holding bfloat16 values."""
    dt = None
    if history_dtype is not None and history_dtype not in ("float32",
                                                           torch.float32):
        if history_dtype not in ("bfloat16", torch.bfloat16):
            raise ValueError(f"history_dtype must be float32 or bfloat16, "
                             f"got {history_dtype!r}")
        dt = torch.bfloat16
    if on_segment is not None and (int(thin) > 1 or dt is not None):
        raise ValueError(
            "thin/history_dtype compress the asynchronous history copy and "
            "are incompatible with on_segment (which gets synchronous "
            "full-resolution float32 blocks)")
    return dt


def _chains_of(hist: torch.Tensor) -> torch.Tensor:
    """The usual layout: ``(n, d, C)`` rows of a history -> ``(C, n, d)``."""
    return hist.permute(2, 0, 1)


class FusedRun:
    """What every fused driver does around its launches.

    * **Checkpoint.**  ``shard``'s file of ``checkpoint_path``; on
      ``resume`` the saved arrays are :attr:`arrays` (None on a fresh run
      or when there is no file) and :attr:`done` the steps they hold.
      :meth:`save` adds the counters, ``steps_run`` and the kernel seed to
      the driver's own arrays, and ``meta`` (with the world size), which a
      resume checks.
    * **Seed.**  :meth:`kernel_seed`: the checkpoint's, else ``seed``, else
      one draw of the generator.
    * **Counters.**  One float64 ``(C,)`` tensor per name of ``counters``
      (``g_att``, ``g_acc``, ``l_acc``), a launch's counts added pro rata
      (``take / T``: the kernel always runs ``T`` steps); without
      ``g_att`` every step is a global attempt.
    * **History.**  ``layout`` maps a launch's history rows ``(n, ...)`` to
      ``(C, n, d)`` on the card (default: ``(n, d, C)`` rows).  With
      ``collect_history`` the rows go to the host asynchronously
      (``thin``, ``history_dtype``) or, with ``on_segment``, synchronously
      as float32 blocks handed to it; :meth:`finish` returns the initial
      row followed by them, else every chain's final state ``(C, 1, d)``.
    """

    def __init__(self, shard, dev, checkpoint_path, resume, meta, *,
                 collect_history: bool = True, on_segment=None, thin=1,
                 history_dtype=None, counters=_COUNTERS, layout=None):
        self.shard, self.dev = shard, dev
        self.meta = {**meta, **shard.meta}
        self.path = shard.path(checkpoint_path, resume)
        restored = (restore_epoch_ckpt(self.path, self.meta)
                    if resume and self.path is not None else None)
        self.arrays, self.done = restored or (None, 0)
        self.seed = None
        self.names = tuple(counters)
        self.counters = [
            torch.zeros(shard.local, dtype=torch.float64, device=dev)
            if self.arrays is None else self.tensors(k)[0]
            for k in self.names]
        self.collect, self.on_segment = collect_history, on_segment
        self.hist_dt = _history_dtype(thin, history_dtype, on_segment)
        self.layout = layout or _chains_of
        self._sink = _AsyncBlocks(self.layout, shard.gather, thin,
                                  self.hist_dt)
        self._blocks = []
        self._head = None

    @property
    def resumed(self) -> bool:
        return self.arrays is not None

    def tensors(self, *names) -> tuple:
        """The checkpoint's arrays ``names`` as tensors on the run's
        device."""
        return tuple(torch.as_tensor(self.arrays[k], device=self.dev)
                     for k in names)

    def initial_chains(self, problem, generator, theta0, y0=None):
        """Every chain's initial ``(theta, y, logk)``, rows = chains (the
        generator moves as in a one-device run; a rank keeps its own with
        ``shard.keep``), and the history's first row when it is
        collected."""
        theta, y, logk = initial_chains(problem, generator, theta0,
                                        self.shard.total, y0, self.dev)
        if self.collect:
            self._head = to_host(theta)[:, None, :]
        return theta, y, logk

    def kernel_seed(self, seed, generator) -> int:
        """The kernels' seed: the checkpoint's on a resume, else ``seed``,
        else one draw of ``generator``."""
        if self.resumed:
            self.seed = int(self.arrays["seed"])
        elif seed is not None:
            self.seed = int(seed)
        else:
            self.seed = int(torch.randint(0, 2**31 - 1, (1,),
                                          generator=generator,
                                          device=generator.device))
        return self.seed

    def launched(self, hist, take: int, T: int, counts=()) -> None:
        """A launch of ``T`` steps of which the run keeps ``take``: its
        history rows ``hist[:take]`` and its per-chain ``counts``, one
        tensor per counter."""
        if self.collect:
            self._history(hist, take)
        frac = take / T
        for acc, x in zip(self.counters, counts):
            acc += x.to(torch.float64) * frac
        self.done += take

    def _history(self, hist, take: int) -> None:
        if self.on_segment is not None:
            block = self.host(self.layout(hist[:take]).contiguous())
            self.on_segment(block, self.done)
            self._blocks.append(block)
        else:
            self._sink.add(hist, take, self.done)

    def save(self, state: dict) -> None:
        """Checkpoint after an aligned segment: ``state`` and the run's
        own arrays."""
        if self.path is None:
            return
        arrays = {**state, **dict(zip(self.names, self.counters))}
        if self.seed is not None:
            arrays.update(steps_run=self.done, seed=self.seed)
        _save(self.path, arrays, self.done, self.meta)

    def host(self, x: torch.Tensor) -> np.ndarray:
        """Every rank's chains of ``x`` on the host."""
        return to_host(self.shard.gather(x))

    def finish(self, theta):
        """``(thetas, counts)``: the history, or every chain's final state
        from the final ``theta`` in the kernel's layout; the counters as
        ``MoveCounts`` of every chain (None without counters)."""
        last = self.layout(theta[None])
        if not self.collect:
            thetas = self.host(last.contiguous())
        else:
            blocks = (self._blocks if self.on_segment is not None
                      else self._sink.blocks())
            head = [] if self._head is None else [self._head]
            if head and self.hist_dt is not None:
                head = [torch.from_numpy(head[0]).to(self.hist_dt).float()
                        .numpy()]
            thetas = (np.concatenate(head + blocks, axis=1) if head + blocks
                      else np.zeros((self.shard.total, 0, last.shape[-1]),
                                    np.float32))
        if not self.names:
            return thetas, None
        C = self.shard.total
        n = {k: np.rint(self.host(c)).astype(np.int32)
             for k, c in zip(self.names, self.counters)}
        g_att = n.get("g_att", np.full((C,), self.done, np.int32))
        return thetas, MoveCounts(
            global_attempts=g_att, global_accepts=n["g_acc"],
            local_attempts=(self.done - g_att).astype(np.int32),
            local_accepts=n.get("l_acc", np.zeros((C,), np.int32)))
