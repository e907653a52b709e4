"""Shared sampler machinery: moves, results and the segmented driver.

Port of ``glabc_tpu/samplers/base.py``.  Where the JAX package vmaps a
per-chain step and scans it, every function here steps all chains at once
as one batched tensor: ``theta (C, d)``, ``y (C, d_y)``, ``log_kernel (C,)``.
Randomness comes from one ``torch.Generator`` consumed in a fixed order, so
the same generator state gives the same chains however the run is segmented.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.resampling import categorical_from_log_weights

__all__ = ["StepOut", "MoveCounts", "local_rw_move", "isir_move",
           "independence_mh_move", "run_segmented", "SamplerResult"]


class StepOut(NamedTuple):
    theta: torch.Tensor      # (C, d)
    accepted: torch.Tensor   # (C,) bool
    is_global: torch.Tensor  # (C,) bool


class MoveCounts(NamedTuple):
    """Per-chain move bookkeeping, one ``(C,)`` int32 array per field."""

    global_attempts: Any
    global_accepts: Any
    local_attempts: Any
    local_accepts: Any

    @staticmethod
    def zeros(num_chains: int, device=None) -> "MoveCounts":
        z = torch.zeros(num_chains, dtype=torch.int32, device=device)
        return MoveCounts(z, z.clone(), z.clone(), z.clone())

    def update(self, is_global, accepted) -> "MoveCounts":
        ig = is_global.to(torch.int32)
        acc = accepted.to(torch.int32)
        return MoveCounts(self.global_attempts + ig,
                          self.global_accepts + ig * acc,
                          self.local_attempts + (1 - ig),
                          self.local_accepts + (1 - ig) * acc)

    def numpy(self) -> "MoveCounts":
        return MoveCounts(*(x.cpu().numpy() if isinstance(x, torch.Tensor)
                            else np.asarray(x) for x in self))


def _select(pred, a, b):
    """Row-wise select for ``(C,)`` predicates on ``(C,)``/``(C, d)``."""
    return torch.where(pred.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def local_rw_move(problem, local_proposal, generator, theta, y,
                  log_kernel_old, support_retries: int = 0):
    """Random-walk Metropolis local move (``GLMCMC.py:91-104``):
    ``theta' = theta + xi``, accepted with ``log a = log pi(theta') +
    log K(y') - log pi(theta) - log K(y)``.

    ``support_retries + 1`` perturbations are drawn at once and the first
    with finite prior mass is used (the reference's resample-while-outside
    loop, ``GLMCMC.py:92-93``).  Returns ``(theta, y, log_kernel,
    accepted)``."""
    C, d = theta.shape
    n_cand = support_retries + 1
    steps = local_proposal.sample(n_cand * C, generator).reshape(n_cand, C, d)
    cands = theta[None] + steps
    if support_retries > 0:
        finite = torch.isfinite(problem.prior_log_prob(cands))   # (n_cand, C)
        first = torch.argmax(finite.to(torch.int32), dim=0)
        pick = torch.where(finite.any(dim=0), first,
                           torch.full_like(first, n_cand - 1))
        theta_prop = cands[pick, torch.arange(C, device=theta.device)]
    else:
        theta_prop = cands[0]
    y_prop = problem.simulate(theta_prop, generator)
    lk_prop = problem.kernel_log_prob(problem.discrepancy(y_prop))
    log_acc = (problem.prior_log_prob(theta_prop) + lk_prop
               - problem.prior_log_prob(theta) - log_kernel_old)
    log_u = torch.log(torch.rand(C, generator=generator, device=theta.device))
    accepted = log_u < log_acc   # NaN compares False: reject
    return (_select(accepted, theta_prop, theta), _select(accepted, y_prop, y),
            torch.where(accepted, lk_prop, log_kernel_old), accepted)


def isir_move(problem, proposal, generator, theta, y, log_kernel_old,
              batch_size: int):
    """iSIR global move (``GLMCMC.py:66-89``): ``batch_size`` proposals,
    one simulation each, log-weights ``log pi + log K - log q``, the current
    state prepended with its own weight, one index drawn by Gumbel-max.
    Index 0 means stay.  NaN proposal rows and NaN weights get zero mass.
    Returns ``(theta, y, log_kernel, accepted)``."""
    C, d = theta.shape
    B = batch_size
    theta_prop, log_q = proposal(C * B, generator)
    theta_prop = theta_prop.reshape(C, B, d)
    log_q = log_q.reshape(C, B)
    nan_row = torch.isnan(theta_prop).any(dim=-1)
    theta_sim = torch.where(nan_row[..., None], torch.zeros_like(theta_prop),
                            theta_prop)
    x = problem.simulate(theta_sim, generator)                   # (C, B, d_y)
    lk_prop = problem.kernel_log_prob(problem.discrepancy(x))     # (C, B)
    log_w_prop = problem.prior_log_prob(theta_prop) + lk_prop - log_q
    log_w_prop = torch.where(nan_row, torch.full_like(log_w_prop, -math.inf),
                             log_w_prop)
    log_w_old = (problem.prior_log_prob(theta) + log_kernel_old
                 - proposal.log_prob(theta))
    log_w = torch.cat([log_w_old[:, None], log_w_prop], dim=1)   # (C, B+1)
    ind = categorical_from_log_weights(log_w, generator)
    rows = torch.arange(C, device=theta.device)
    thetas = torch.cat([theta[:, None], theta_prop], dim=1)
    ys = torch.cat([y[:, None], x], dim=1)
    lks = torch.cat([log_kernel_old[:, None], lk_prop], dim=1)
    return thetas[rows, ind], ys[rows, ind], lks[rows, ind], ind != 0


def independence_mh_move(problem, global_proposal, generator, theta, y,
                         log_kernel_old):
    """Independence Metropolis-Hastings global move
    (``GlobalMCMC.py:39-53``): ``log a = log pi(theta') + log K(y') +
    log q(theta) - log q(theta') - log pi(theta) - log K(y)``."""
    C = theta.shape[0]
    theta_prop, log_q_prop = global_proposal(C, generator)
    y_prop = problem.simulate(theta_prop, generator)
    lk_prop = problem.kernel_log_prob(problem.discrepancy(y_prop))
    log_acc = (problem.prior_log_prob(theta_prop) + lk_prop
               + global_proposal.log_prob(theta) - log_q_prop
               - problem.prior_log_prob(theta) - log_kernel_old)
    log_u = torch.log(torch.rand(C, generator=generator, device=theta.device))
    accepted = log_u < log_acc
    return (_select(accepted, theta_prop, theta), _select(accepted, y_prop, y),
            torch.where(accepted, lk_prop, log_kernel_old), accepted)


@dataclasses.dataclass
class SamplerResult:
    """Host-side result of a multi-chain run."""

    thetas: np.ndarray        # (C, T, d), initial state at t=0
    counts: MoveCounts        # per-chain numpy arrays (C,)
    final_carry: Any

    @property
    def num_chains(self) -> int:
        return self.thetas.shape[0]

    def chain(self, i: int = 0) -> np.ndarray:
        return self.thetas[i]

    def acceptance_rates(self):
        c = self.counts.numpy()
        tot_att = c.global_attempts + c.local_attempts
        tot_acc = c.global_accepts + c.local_accepts
        return {
            "global": c.global_accepts / np.maximum(c.global_attempts, 1),
            "local": c.local_accepts / np.maximum(c.local_attempts, 1),
            "overall": tot_acc / np.maximum(tot_att, 1),
        }


def run_segmented(step: Callable, carry, num_steps: int,
                  segment_size: int = 10_000,
                  on_segment: Optional[Callable[[np.ndarray, int], None]] = None,
                  checkpoint: Optional[Callable[[Any, int], None]] = None,
                  step_offset: int = 0,
                  progress: bool = False):
    """Run ``num_steps`` batched steps in host-visible segments.

    ``step(carry) -> (carry, StepOut)``.  Each segment's ``(C, S, d)`` theta
    block goes to the host and to ``on_segment(block, start_index)``;
    ``checkpoint(carry, steps_done)`` runs after each segment.  With
    ``progress`` one line per segment goes to stderr, each starting with a
    carriage return: the steps done and the transitions a second since the
    first segment (the reference's tqdm bar, ``GlobalMCMC.py:37``).
    Returns ``(carry, thetas (C, num_steps, d))``."""
    blocks = []
    done = 0
    t_start = None
    while done < num_steps:
        take = min(segment_size, num_steps - done)
        seg = []
        for _ in range(take):
            carry, out = step(carry)
            seg.append(out.theta)
        block = torch.stack(seg, dim=1).cpu().numpy()   # (C, S, d)
        if on_segment is not None:
            on_segment(block, step_offset + done)
        blocks.append(block)
        done += take
        if checkpoint is not None:
            checkpoint(carry, step_offset + done)
        if progress:
            now = time.time()
            if t_start is None:
                t_start, rate = now, 0.0
            else:
                rate = done * block.shape[0] / max(now - t_start, 1e-9)
            print(f"\r[{step_offset + done}/{step_offset + num_steps}] "
                  f"{rate:,.0f} transitions/s", end="", file=sys.stderr)
            if done >= num_steps:
                print(file=sys.stderr)
    thetas = (np.concatenate(blocks, axis=1) if blocks
              else np.zeros((0, 0, 0), np.float32))
    return carry, thetas
