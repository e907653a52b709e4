"""Chain carry and the multi-chain sample driver of the plain samplers.

Port of ``glabc_tpu/samplers/chain.py``.  The carry holds every chain as one
batched tensor and the run's single ``torch.Generator``; a checkpoint stores
the tensors and the generator's state as named arrays.

Under ``mesh=`` the plain path stays exact: its one generator draws for
every chain at once, so each rank runs the whole one-device run (no
collective) and returns its result bit for bit, at the one-device cost on
every rank: the plain path is the reference, the fused drivers are the
sharded path.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .._device import check_generator, resolve_device
from ..models.problems import initial_chains
from ..utils.io import carry_path, load_carry, save_carry
from ._shard import ChainShard
from .base import MoveCounts, SamplerResult, run_segmented

__all__ = ["ChainCarry", "init_chain_carry", "sample_with_step"]


class ChainCarry(NamedTuple):
    theta: torch.Tensor        # (C, d)
    y: torch.Tensor            # (C, d_y)
    log_kernel: torch.Tensor   # (C,) cached log K_eps(discrepancy(y))
    generator: torch.Generator
    counts: MoveCounts

    def to_arrays(self) -> dict:
        out = {"theta": self.theta, "y": self.y, "log_kernel": self.log_kernel,
               "rng_state": self.generator.get_state()}
        out.update({f"counts.{k}": v
                    for k, v in self.counts._asdict().items()})
        return out

    @classmethod
    def from_arrays(cls, arrays: dict, generator: torch.Generator,
                    device) -> "ChainCarry":
        t = lambda k: torch.as_tensor(arrays[k], device=device)
        generator.set_state(torch.as_tensor(arrays["rng_state"]))
        counts = MoveCounts(*(t(f"counts.{k}") for k in MoveCounts._fields))
        return cls(t("theta"), t("y"), t("log_kernel"), generator, counts)


def init_chain_carry(problem, generator, theta0, y0=None,
                     num_chains: int = 1, device=None) -> ChainCarry:
    """Batched carry.  ``theta0`` ``(d,)`` broadcasts to every chain, or is
    ``(C, d)``.  ``y0=None`` simulates each chain's initial dataset
    (``Mixture.py:66``); see :func:`~glabc_tpu_torch.models.problems.
    initial_chains`."""
    dev = resolve_device(device)
    check_generator(generator, dev)
    theta, y, log_kernel = initial_chains(
        problem, generator, theta0, _num_chains(theta0, num_chains), y0, dev)
    return ChainCarry(theta, y, log_kernel, generator,
                      MoveCounts.zeros(theta.shape[0], dev))


def sample_with_step(problem, step: Callable, generator, num_ite: int, theta0,
                     y0=None, num_chains: int = 1, segment_size: int = 10_000,
                     on_segment: Optional[Callable] = None,
                     checkpoint_path: Optional[str] = None,
                     resume: bool = False, mesh=None, device=None,
                     progress: bool = False) -> SamplerResult:
    """Run the batched ``step(carry) -> (carry, StepOut)`` for ``num_ite - 1``
    transitions; the chains have length ``num_ite`` with the initial state at
    index 0 (``GLMCMC.py:43-47``).

    With ``checkpoint_path`` the carry (tensors, counters, generator state)
    is saved after every segment; ``resume=True`` restores it and the result
    holds only the remaining transitions.

    ``mesh``: a 1-D ``DeviceMesh``; every rank calls with the same
    arguments and generator seed and returns the whole result (see the
    module docstring); the chain count must divide by its size, and each
    rank checkpoints to its own file.

    ``progress``: one line per segment on stderr (``run_segmented``)."""
    dev = resolve_device(device)
    return drive_plain(
        step, generator, num_ite, ChainCarry,
        lambda: init_chain_carry(problem, generator, theta0, y0, num_chains,
                                 dev),
        _num_chains(theta0, num_chains), segment_size, on_segment,
        checkpoint_path, resume, mesh, dev, progress)


def _num_chains(theta0, num_chains: int) -> int:
    th = np.asarray(theta0)
    return th.shape[0] if th.ndim == 2 else int(num_chains)


def drive_plain(step: Callable, generator, num_ite: int, carry_cls,
                init: Callable, num_chains: int, segment_size: int,
                on_segment, checkpoint_path, resume: bool, mesh,
                dev, progress: bool = False) -> SamplerResult:
    """The plain samplers' loop: ``init()`` the carry (or restore it),
    ``num_ite - 1 - start`` steps in segments, checkpoints and the result.
    Under ``mesh`` every rank runs the whole run and checkpoints the whole
    carry to its own file, with the world size.  ``carry_cls`` has
    ``to_arrays`` / ``from_arrays``."""
    shard = ChainShard(num_chains, mesh)
    path = shard.path(checkpoint_path, resume)
    start = 0
    carry = None
    if resume and path is not None and os.path.exists(carry_path(path)):
        arrays, start = load_carry(path)
        saved = int(arrays.pop("meta.world_size", 1))
        if saved != shard.world:
            raise ValueError(f"checkpoint was saved on world size {saved}, "
                             f"this run has {shard.world}")
        carry = carry_cls.from_arrays(arrays, check_generator(generator, dev),
                                      dev)
    if carry is None:
        carry = init()
    theta_init = carry.theta.cpu().numpy()[:, None, :]
    save = None
    if path is not None:
        save = lambda c, done: save_carry(
            path, {**c.to_arrays(), "meta.world_size": shard.world}, done)
    carry, thetas = run_segmented(step, carry, (num_ite - 1) - start,
                                  segment_size, on_segment, save,
                                  step_offset=start, progress=progress)
    if thetas.size and start == 0:
        thetas = np.concatenate([theta_init, thetas], axis=1)
    elif not thetas.size:
        thetas = theta_init
    counts = MoveCounts(*(c.cpu().numpy() for c in carry.counts))
    return SamplerResult(thetas=thetas, counts=counts, final_carry=carry)
