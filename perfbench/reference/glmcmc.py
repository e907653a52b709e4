"""GLMCMC on the Mixture problem, step by step in plain torch.

The transition of the GL-ABC-MCMC reference (``GLMCMC.py``: a coin picks
iSIR over ``B`` importance draws or a random-walk MH move), on the random
numbers of the port's kernels: at absolute step ``s`` chain ``c`` of a run
keyed by ``seed`` reads Philox blocks ``(c, s, 0..)``: ``ceil((B + 3) / 4)``
blocks of scalars (Gumbels ``0..B``, the local uniform, the coin), then one
block of two Box-Muller pairs per two dims for each of the ``B`` proposals
and the local move (``n1``: the proposal's normals, ``n2``: the
simulator's).  Every float operation is written in the order a float32 run
performs it, so a sound run agrees with it chain by chain except where a
decision sits on a rounding.  Rows are independent (chain, run) pairs, each
with its own seed, so rows of many runs step together.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .mixture import (Problem, discrepancy, f32, gauss_lp, kern_lp,
                      kernel_log_prob, prior_lp)
from .philox import gumbel, normal_pair, uniforms


class Moves(NamedTuple):
    """The sampler's settings, float32-rounded."""

    B: int
    gf: float
    lp_scale: float
    ip_loc: float
    ip_scale: float
    inv_ip_scale: float
    c_ip: float

    @classmethod
    def create(cls, batch_size, global_frequency, lp_scale, ip_loc=0.0,
               ip_scale=1.0) -> "Moves":
        return cls(int(batch_size), f32(global_frequency), f32(lp_scale),
                   f32(ip_loc), f32(ip_scale), f32(1.0 / ip_scale),
                   f32(-0.5 * math.log(2.0 * math.pi) - math.log(ip_scale)))


def initial_log_kernel(pb: Problem, y0: torch.Tensor) -> torch.Tensor:
    """The starting state's log-kernel: ``log N(|y0 - y_obs|; 0, eps^2)``."""
    return kernel_log_prob(discrepancy(pb, y0),
                           torch.tensor(pb.epsilon, dtype=torch.float32,
                                        device=y0.device))


def step_noise(pb: Problem, mv: Moves, seed, chain, step, dtype):
    """One step's noise for rows ``chain`` (see the module docstring)."""
    B, d = mv.B, pb.d
    sb = -(-(B + 3) // 4)
    pb_blocks = -(-d // 2)
    u = uniforms(seed, chain, step, sb + (B + 1) * pb_blocks)
    R = chain.shape[0]
    pairs = (u[:, 4 * sb:].reshape(R, B + 1, 4 * pb_blocks)[:, :, :2 * d]
             .reshape(R, B + 1, d, 2)).to(dtype)
    n1, n2 = normal_pair(pairs[..., 0], pairs[..., 1])
    sc = u[:, :B + 3].to(dtype)
    return gumbel(sc[:, :B + 1]), sc[:, B + 1], sc[:, B + 2], n1, n2


def transition(pb: Problem, mv: Moves, state, noise):
    """One GLMCMC step of every row.  Returns the new state and the
    increments ``(global attempt, global accept, local accept)``."""
    theta, y, logk = state
    g, u_local, u_coin, n1, n2 = noise
    B = mv.B
    ip = lambda th: gauss_lp(th, mv.ip_loc, mv.inv_ip_scale, mv.c_ip)
    lp_theta = prior_lp(pb, theta)
    # iSIR as a streaming Gumbel-argmax; strict > keeps the earlier on ties
    best = ((lp_theta + logk) - ip(theta)) + g[:, 0]
    w_th, w_y, w_lk = theta, y, logk
    w_moved = torch.zeros_like(u_coin, dtype=torch.bool)
    for b in range(B):
        thp = mv.ip_loc + mv.ip_scale * n1[:, b]
        yp = thp.abs() + pb.sigma * n2[:, b]
        lkp = kern_lp(pb, yp)
        score = ((prior_lp(pb, thp) + lkp) - ip(thp)) + g[:, b + 1]
        upd = score > best
        best = torch.where(upd, score, best)
        w_th = torch.where(upd[:, None], thp, w_th)
        w_y = torch.where(upd[:, None], yp, w_y)
        w_lk = torch.where(upd, lkp, w_lk)
        w_moved = w_moved | upd
    # local random-walk MH
    thl = theta + mv.lp_scale * n1[:, B]
    yl = thl.abs() + pb.sigma * n2[:, B]
    lkl = kern_lp(pb, yl)
    l_acc = torch.log(u_local) < ((prior_lp(pb, thl) + lkl) - lp_theta) - logk
    is_g = u_coin < mv.gf
    new = (torch.where(is_g[:, None], w_th,
                       torch.where(l_acc[:, None], thl, theta)),
           torch.where(is_g[:, None], w_y,
                       torch.where(l_acc[:, None], yl, y)),
           torch.where(is_g, w_lk, torch.where(l_acc, lkl, logk)))
    return new, (is_g, is_g & w_moved, ~is_g & l_acc)


def replay(pb: Problem, mv: Moves, seeds: torch.Tensor, chain: torch.Tensor,
           theta0: torch.Tensor, y0: torch.Tensor, steps: int,
           dtype=torch.float32):
    """``steps`` transitions (absolute steps ``0 .. steps - 1``) of rows
    ``(seeds (R,), chain (R,))`` from ``theta0, y0 (R, d)``.  Returns
    ``(theta, y, logk, [global attempts, global accepts, local accepts])``
    with int64 counts; the state is computed in ``dtype`` and returned as
    float32."""
    logk = initial_log_kernel(pb, y0.to(torch.float32))
    state = (theta0.to(dtype), y0.to(dtype), logk.to(dtype))
    counts = [torch.zeros(chain.shape[0], dtype=torch.int64,
                          device=chain.device) for _ in range(3)]
    for s in range(steps):
        state, inc = transition(pb, mv, state,
                                step_noise(pb, mv, seeds, chain, s, dtype))
        counts = [c + i.to(torch.int64) for c, i in zip(counts, inc)]
    return (*(x.to(torch.float32) for x in state), counts)
