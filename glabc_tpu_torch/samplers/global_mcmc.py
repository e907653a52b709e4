"""GlobalMCMC: independence-MH global move + random-walk local, plain torch.

Port of ``glabc_tpu/samplers/global_mcmc.py`` (reference
``glabcmcmc/GlobalMCMC.py:6-98``).  The per-iteration Bernoulli coin
(``GlobalMCMC.py:39``) is drawn for every chain; both moves run and each
chain keeps its coin's.
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from .base import StepOut, _select, independence_mh_move, local_rw_move
from .chain import ChainCarry, sample_with_step

__all__ = ["GlobalMCMCConfig", "build_global_mcmc_step", "run_global_mcmc"]


@dataclasses.dataclass(frozen=True)
class GlobalMCMCConfig:
    global_frequency: float = 0.5
    support_retries: int = 0


def build_global_mcmc_step(problem, global_proposal, local_proposal,
                           cfg: GlobalMCMCConfig):
    """Batched transition.  Returns ``step(carry) -> (carry, StepOut)``."""

    def step(carry: ChainCarry):
        gen = carry.generator
        C = carry.theta.shape[0]
        is_global = torch.rand(C, generator=gen,
                               device=carry.theta.device) < cfg.global_frequency
        g = independence_mh_move(problem, global_proposal, gen, carry.theta,
                                 carry.y, carry.log_kernel)
        loc = local_rw_move(problem, local_proposal, gen, carry.theta, carry.y,
                            carry.log_kernel, cfg.support_retries)
        theta, y, lk, accepted = (_select(is_global, a, b)
                                  for a, b in zip(g, loc))
        counts = carry.counts.update(is_global, accepted)
        return (ChainCarry(theta, y, lk, gen, counts),
                StepOut(theta, accepted, is_global))

    return step


def run_global_mcmc(problem, generator, num_ite, theta0, global_proposal,
                    local_proposal, global_frequency=0.5, y0=None,
                    num_chains: int = 1, segment_size: int = 10_000,
                    on_segment=None, support_retries: int = 0,
                    checkpoint_path=None, resume: bool = False, mesh=None,
                    device=None):
    dev = resolve_device(device)
    cfg = GlobalMCMCConfig(global_frequency, support_retries)
    step = build_global_mcmc_step(problem, global_proposal.to(dev),
                                  local_proposal.to(dev), cfg)
    return sample_with_step(problem, step, generator, num_ite, theta0, y0,
                            num_chains, segment_size, on_segment,
                            checkpoint_path=checkpoint_path, resume=resume,
                            mesh=mesh, device=dev)
