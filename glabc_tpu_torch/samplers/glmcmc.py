"""GLMCMC: iSIR global move + random-walk local move, plain torch path.

Port of ``glabc_tpu/samplers/glmcmc.py`` (reference
``glabcmcmc/GLMCMC.py:24-137``), the counterpart of the JAX scan path and the
statistical reference for the fused kernel on the CPU.  Each step draws every
chain's coin, runs both moves for all chains and selects per chain.
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from .base import StepOut, _select, isir_move, local_rw_move
from .chain import ChainCarry, sample_with_step

__all__ = ["GLMCMCConfig", "build_glmcmc_step", "run_glmcmc"]


@dataclasses.dataclass(frozen=True)
class GLMCMCConfig:
    global_frequency: float = 0.9
    batch_size: int = 5
    support_retries: int = 0


def build_glmcmc_step(problem, importance_proposal, local_proposal,
                      cfg: GLMCMCConfig):
    """Batched transition.  Returns ``step(carry) -> (carry, StepOut)``."""

    def step(carry: ChainCarry):
        gen = carry.generator
        C = carry.theta.shape[0]
        is_global = torch.rand(C, generator=gen,
                               device=carry.theta.device) < cfg.global_frequency
        g = isir_move(problem, importance_proposal, gen, carry.theta, carry.y,
                      carry.log_kernel, cfg.batch_size)
        loc = local_rw_move(problem, local_proposal, gen, carry.theta, carry.y,
                            carry.log_kernel, cfg.support_retries)
        theta, y, lk, accepted = (_select(is_global, a, b)
                                  for a, b in zip(g, loc))
        counts = carry.counts.update(is_global, accepted)
        return (ChainCarry(theta, y, lk, gen, counts),
                StepOut(theta, accepted, is_global))

    return step


def run_glmcmc(problem, generator, num_ite, theta0, importance_proposal,
               local_proposal, global_frequency=0.9, batch_size=5, y0=None,
               num_chains: int = 1, segment_size: int = 10_000,
               on_segment=None, support_retries: int = 0,
               checkpoint_path=None, resume: bool = False, mesh=None,
               device=None):
    dev = resolve_device(device)
    cfg = GLMCMCConfig(global_frequency, batch_size, support_retries)
    step = build_glmcmc_step(problem, importance_proposal.to(dev),
                             local_proposal.to(dev), cfg)
    return sample_with_step(problem, step, generator, num_ite, theta0, y0,
                            num_chains, segment_size, on_segment,
                            checkpoint_path=checkpoint_path, resume=resume,
                            mesh=mesh, device=dev)
