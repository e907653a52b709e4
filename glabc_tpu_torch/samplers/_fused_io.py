"""Checkpoint/resume for the fused-kernel and adaptive samplers, and their
copies to the host.

Port of ``glabc_tpu/samplers/_fused_io.py``.  The loop state is the kernel's
state tensors plus host counters (fused loop), or any mapping of names to
arrays (adaptive epochs), saved as the port's own ``.npz`` of named arrays.

Alignment rule: the kernel always runs ``steps_per_call`` transitions, so
after a ragged final segment the carry is ahead of the recorded history.
Only aligned segments are checkpointed; a resume continues from the last
aligned point and replays the ragged tail bitwise, since every draw is a
function of (seed, chain, absolute step).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.io import carry_path, load_carry, save_carry
from ..utils.profiling import annotate

__all__ = ["to_host", "save_fused_ckpt", "restore_fused_ckpt",
           "save_epoch_ckpt", "restore_epoch_ckpt"]

_STATE = ("theta", "y", "logk")
_COUNTERS = ("g_att", "g_acc", "l_acc")


def to_host(x: torch.Tensor) -> np.ndarray:
    """``x`` as a numpy array on the host; the copy is a ``glabc.io.d2h``
    span that counts its bytes."""
    with annotate("glabc.io.d2h", x.numel() * x.element_size()):
        return x.cpu().numpy()


def save_fused_ckpt(path, state, counters, steps_run, call_idx, seed, done,
                    take, steps_per_call, meta=None):
    """Snapshot the fused loop after an aligned launch (a ragged final
    segment is not saved).  ``meta`` holds the configuration, which
    :func:`restore_fused_ckpt` checks."""
    if take != steps_per_call:
        return
    arrays = dict(zip(_STATE, state))
    arrays.update(zip(_COUNTERS, counters))
    arrays.update(steps_run=steps_run, call_idx=call_idx, seed=seed)
    for k, v in (meta or {}).items():
        arrays[f"meta.{k}"] = v
    save_carry(path, arrays, step=done)


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


def restore_fused_ckpt(path, expect_meta=None, device=None):
    """``(state, (g_att, g_acc, l_acc), steps_run, call_idx, seed, done)``,
    or ``None`` when there is no checkpoint.  State tensors go to
    ``device``; counters come back as float64 numpy.  Raises ``ValueError``
    when the saved configuration differs from ``expect_meta``."""
    if not os.path.exists(carry_path(path)):
        return None
    arrays, done = load_carry(path)
    _check_meta(arrays, expect_meta)
    state = tuple(torch.as_tensor(arrays[k], device=device) for k in _STATE)
    counters = tuple(np.asarray(arrays[k], np.float64) for k in _COUNTERS)
    return (state, counters, int(arrays["steps_run"]),
            int(arrays["call_idx"]), int(arrays["seed"]), int(done))


# The adaptive samplers (AGLMCMC) interleave segments with adaptation epochs.
# Their checkpoints hold the loop state before the epoch that follows an
# aligned segment; a resumed run does that epoch first (the generator
# state is saved with it, so the epoch replays bitwise) and goes on with no
# history overlap.

def save_epoch_ckpt(path, state, done, take, seg_len, meta=None):
    """Snapshot an adaptive sampler's loop state (a mapping of names to
    tensors, arrays or numbers) after an aligned segment (``take ==
    seg_len``; a ragged final segment is not saved)."""
    if take != seg_len:
        return
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
