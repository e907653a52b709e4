"""Tile programs: an ABC problem and its proposals for the generic fused
kernels, as two twins of one definition.

Port of ``glabc_tpu/ops/pallas/generic_kernel.py``'s ``TileLib``,
``TileProgram``, ``mixture_tile_program`` and ``ma2_tile_program``.  In JAX
a program is a set of Python callables that Pallas traces into the kernel.
CUDA has no tracing, so a program here is

* a device struct in a header under ``csrc/programs/`` (``mixture.cuh``,
  ``ma2.cuh``): ``D``/``Y`` (theta_dim, y_rows) and ``__device__ static``
  callables on per-thread register arrays, reading the program's numbers
  from a float parameter array passed at launch, so one build serves every
  epsilon and ``y_obs``;
* this module's :class:`TileProgram`: the header's path, its ``-D``
  defines, the parameter vector, the Philox-block budget of each random
  callable, and the same callables in torch on ``(d, C)`` / ``(y_rows, C)``
  tensors with the same float operations in the same order.  The plain
  versions of the generic kernels call them; on the card the kernels are
  held against them.

Random callables take a draws cursor (:class:`~.philox.Draws`): uniforms
and Box-Muller pairs from consecutive Philox blocks.  A simulator cursor
may be ``paired``: it re-reads the blocks of the proposal that made its
theta, and the Mixture program then takes the sin branch of the proposal's
pairs for its noise, the pairing JAX makes through ``tl._mix_noise``.

A user's own program is a header plus a :class:`TileProgram` twin; the
kernels build once per (kernel source, header, defines) at first use.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

__all__ = ["TileProgram", "check_program", "mixture_tile_program",
           "ma2_tile_program", "NEG", "rowsum", "div"]

_LOG_2PI = math.log(2.0 * math.pi)
NEG = -1.0e30   # -inf stand-in: never wins an argmax, always rejects, and
                # makes no NaN through (-inf) - (-inf)


def _f32(x) -> float:
    return float(np.float32(x))


def rowsum(x: torch.Tensor) -> torch.Tensor:
    """``(k, C) -> (C,)``: the rows summed first to last, as the headers'
    loops add them."""
    s = x[0]
    for j in range(1, x.shape[0]):
        s = s + x[j]
    return s


def div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` rounded once, as a kernel divides.  (On the card torch
    divides by a host scalar through its reciprocal; a divisor on the
    tensor's device is divided by.)"""
    return x / torch.tensor(v, dtype=x.dtype, device=x.device)


def _col(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32,
                        device=like.device)[:, None]


@dataclasses.dataclass(frozen=True, eq=False)
class TileProgram:
    """An ABC problem and its proposals for the generic fused kernels.

    ``header`` is the device struct's path under ``csrc/``; ``defines`` are
    ``-D`` pairs its build needs; ``params`` is the float parameter vector
    the kernel reads.  ``global_blocks``, ``sim_blocks`` and
    ``local_blocks`` are the Philox blocks ``sample_global``, ``simulate``
    and ``sample_local`` may read; ``sim_paired``: ``simulate`` after a
    proposal re-reads that proposal's blocks (``paired=True`` cursor)
    instead of blocks of its own.

    Callables (theta ``(d, C)``, y ``(y_rows, C)``, log densities
    ``(C,)``; out-of-support log densities are :data:`NEG`, not ``-inf``):
    ``sample_global(draws)``, ``simulate(theta, draws)``,
    ``simulate_pair(theta_a, theta_b, draws)`` (both simulations on one
    cursor, the noise drawn once: K9's +-fd pair; each result bitwise
    ``simulate``'s), ``log_kernel(y)``, ``prior_minus_global_lp(theta)``,
    ``prior_diff_lp(a, b)``, ``sample_local(theta, draws)``,
    ``prior_lp(theta)``, ``discrepancy(y)``, ``prior_grad(theta)``."""

    name: str
    theta_dim: int
    y_rows: int
    header: str
    defines: tuple
    params: tuple
    global_blocks: int
    sim_blocks: int
    local_blocks: int
    sim_paired: bool
    sample_global: Callable
    simulate: Callable
    simulate_pair: Callable
    log_kernel: Callable
    prior_minus_global_lp: Callable
    prior_diff_lp: Callable
    sample_local: Callable
    prior_lp: Callable
    discrepancy: Callable
    prior_grad: Callable

    def params_on(self, device) -> torch.Tensor:
        """The parameter vector as a float32 tensor on ``device``."""
        return torch.tensor(self.params, dtype=torch.float32, device=device)

    def sim_offset(self, proposal_blocks: int) -> int:
        """Where a simulation starts, relative to its proposal's first
        block."""
        return 0 if self.sim_paired else proposal_blocks

    def slot_blocks(self, proposal_blocks: int) -> int:
        """Blocks of one proposal and its simulation."""
        return max(proposal_blocks,
                   self.sim_offset(proposal_blocks) + self.sim_blocks)

    @property
    def build_key(self) -> tuple:
        """What a kernel's build depends on besides its source."""
        return (self.header, tuple(self.defines))


def check_program(problem, program) -> None:
    """Raise unless ``program`` is a :class:`TileProgram` of ``problem``'s
    widths: the drivers take the problem's initial states into the
    program's kernel."""
    if not isinstance(program, TileProgram):
        raise TypeError("tile_program must be a glabc_tpu_torch TileProgram "
                        "(a CUDA header and its torch twin), got "
                        f"{type(program).__name__}")
    if program.theta_dim != problem.theta_dim:
        raise ValueError(f"program.theta_dim {program.theta_dim} != "
                         f"problem.theta_dim {problem.theta_dim}")
    if program.y_rows != problem.y_dim:
        raise ValueError(f"program.y_rows {program.y_rows} != "
                         f"problem.y_dim {problem.y_dim}")


def mixture_tile_program(problem, *, ip_loc=0.0, ip_scale=1.0,
                         lp_scale=0.35, prior_loc=0.0, prior_scale=1.0
                         ) -> TileProgram:
    """The Mixture family (``examples/Mixture.py:5-53``): Gaussian prior and
    proposals, ``y = |theta| + sigma z``, Euclidean discrepancy, Gaussian
    epsilon-kernel.  Header ``programs/mixture.cuh`` built for
    ``GLABC_MIXTURE_D = theta_dim``."""
    d = int(problem.theta_dim)
    sigma = float(problem._noise_std)
    eps = float(problem.epsilon)
    y_obs = [_f32(v) for v in np.asarray(problem.y_obs).reshape(-1)]
    if len(y_obs) != d:
        raise ValueError(f"the Mixture program needs y_dim == theta_dim, got "
                         f"{len(y_obs)} and {d}")
    ps2, is2 = float(prior_scale) ** 2, float(ip_scale) ** 2
    # prior minus importance proposal as one quadratic per dim
    q2 = _f32(0.5 * (1.0 / is2 - 1.0 / ps2))
    q1 = _f32(prior_loc / ps2 - ip_loc / is2)
    q0 = _f32(np.log(ip_scale) - np.log(prior_scale)
              - 0.5 * prior_loc ** 2 / ps2 + 0.5 * ip_loc ** 2 / is2)
    c_kern = _f32(-0.5 * _LOG_2PI - np.log(eps))
    eps2 = _f32(eps * eps)
    loc, half_inv_ps2 = _f32(prior_loc), _f32(0.5 / ps2)
    ip_loc_, ip_scale_ = _f32(ip_loc), _f32(ip_scale)
    lp, sig = _f32(lp_scale), _f32(sigma)
    c_prior = _f32(-0.5 * _LOG_2PI - np.log(prior_scale))
    scale, ps2_ = _f32(prior_scale), _f32(ps2)
    params = (c_kern, eps2, q2, q1, q0, loc, half_inv_ps2, ip_loc_,
              ip_scale_, lp, sig, c_prior, scale, ps2_, *y_obs)
    pair_blocks = -(-d // 2)

    def sample_global(draws):
        n1, _ = draws.normal_pairs(d)
        return ip_loc_ + ip_scale_ * n1.T

    def simulate(th, draws):
        n1, n2 = draws.normal_pairs(d)
        return th.abs() + sig * (n2 if draws.paired else n1).T

    def simulate_pair(th_a, th_b, draws):
        n1, n2 = draws.normal_pairs(d)
        e = sig * (n2 if draws.paired else n1).T
        return th_a.abs() + e, th_b.abs() + e

    def log_kernel(y):
        diff = y - _col(y_obs, y)
        return c_kern - div(0.5 * rowsum(diff * diff), eps2)

    def prior_minus_global_lp(th):
        return rowsum((q2 * th + q1) * th + q0)

    def prior_diff_lp(a, b):
        za, zb = a - loc, b - loc
        return rowsum((zb * zb - za * za) * half_inv_ps2)

    def sample_local(th, draws):
        n1, _ = draws.normal_pairs(d)
        return th + lp * n1.T

    def prior_lp(th):
        z = div(th - loc, scale)
        return rowsum(c_prior - (0.5 * z) * z)

    def discrepancy(y):
        diff = y - _col(y_obs, y)
        return torch.sqrt(rowsum(diff * diff))

    def prior_grad(th):
        return div(-(th - loc), ps2_)

    return TileProgram(
        name=f"mixture{d}", theta_dim=d, y_rows=d,
        header="programs/mixture.cuh",
        defines=(("GLABC_MIXTURE_D", d),), params=params,
        global_blocks=pair_blocks, sim_blocks=pair_blocks,
        local_blocks=pair_blocks, sim_paired=True,
        sample_global=sample_global, simulate=simulate,
        simulate_pair=simulate_pair, log_kernel=log_kernel,
        prior_minus_global_lp=prior_minus_global_lp,
        prior_diff_lp=prior_diff_lp, sample_local=sample_local,
        prior_lp=prior_lp, discrepancy=discrepancy, prior_grad=prior_grad)


# the importance proposal's box [-2, 2] x [-1, 1] around the prior triangle
_MA2_LO = (-2.0, -1.0)
_MA2_WIDTH = (4.0, 2.0)
_MA2_LOG_P_MINUS_Q = _f32(np.log(8.0 / 4.0))   # box area 8, triangle 4
_MA2_LOG_PRIOR = _f32(np.log(0.25))


def ma2_inside(th: torch.Tensor) -> torch.Tensor:
    """Theta ``(2, C)`` inside the MA(2) prior triangle."""
    th1, th2 = th[0], th[1]
    return (th2 < 1.0) & (th2 > th1 - 1.0) & (th2 > -th1 - 1.0)


def ma2_tile_program(problem, *, lp_scale=0.1) -> TileProgram:
    """MA(2) (:class:`~glabc_tpu_torch.models.problems.MA2Problem`) as a
    program, header ``programs/ma2.cuh``.  The simulator is a scalar
    recursion per chain over the ``num_draws + 2`` innovations ``e_{-2},
    e_{-1}, e_0, ...`` (pair ``i`` of the cursor gives innovations ``2i``
    and ``2i + 1``), with ``y_{-1} = y_{-2} = 0`` and the sums ``s0, s1,
    s2`` taken in t order, then times ``1/T``; no series is kept.  Global
    proposal: uniform on the box ``[-2, 2] x [-1, 1]``, out-of-triangle
    candidates weighted :data:`NEG`; local move: isotropic Gaussian RW."""
    T = int(problem.num_draws)
    y_obs = [_f32(v) for v in np.asarray(problem.y_obs).reshape(-1)]
    if len(y_obs) != 3:
        raise ValueError(f"MA(2) summaries are 3 rows, y_obs has "
                         f"{len(y_obs)}")
    eps = float(problem.epsilon)
    c_kern = _f32(-0.5 * _LOG_2PI - np.log(eps))
    eps2 = _f32(eps * eps)
    lp, inv_t = _f32(lp_scale), _f32(1.0 / T)
    params = (c_kern, eps2, lp, inv_t, float(T), *y_obs)
    n_innov = T + 2

    def sample_global(draws):
        u = draws.uniforms(2).T
        return _col(_MA2_LO, u) + _col(_MA2_WIDTH, u) * u

    def series(th, e):
        y = (e[2:] + th[0] * e[1:-1]) + th[1] * e[:-2]  # (T, C)
        z = torch.zeros_like(y[:2])
        y1 = torch.cat([z[:1], y[:-1]])                 # y_{t-1}
        y2 = torch.cat([z, y[:-2]])                     # y_{t-2}
        prods = torch.stack([y * y, y * y1, y * y2])    # (3, T, C)
        s = prods[:, 0]
        for t in range(1, T):
            s = s + prods[:, t]
        return s * inv_t

    def simulate(th, draws):
        return series(th, draws.normals(n_innov).T)     # e: (T + 2, C)

    def simulate_pair(th_a, th_b, draws):
        e = draws.normals(n_innov).T
        return series(th_a, e), series(th_b, e)

    def log_kernel(y):
        diff = y - _col(y_obs, y)
        return c_kern - div(0.5 * rowsum(diff * diff), eps2)

    def where(cond, a):
        return torch.where(cond, torch.full(cond.shape, a,
                                            device=cond.device),
                           torch.full(cond.shape, NEG, device=cond.device))

    def prior_minus_global_lp(th):
        return where(ma2_inside(th), _MA2_LOG_P_MINUS_Q)

    def prior_diff_lp(a, b):
        return where(ma2_inside(a), 0.0)

    def sample_local(th, draws):
        n1, _ = draws.normal_pairs(2)
        return th + lp * n1.T

    def prior_lp(th):
        return where(ma2_inside(th), _MA2_LOG_PRIOR)

    def discrepancy(y):
        diff = y - _col(y_obs, y)
        return torch.sqrt(rowsum(diff * diff))

    def prior_grad(th):
        return torch.zeros_like(th)

    return TileProgram(
        name="ma2", theta_dim=2, y_rows=3, header="programs/ma2.cuh",
        defines=(), params=params, global_blocks=1,
        sim_blocks=-(-(2 * -(-n_innov // 2)) // 4), local_blocks=1,
        sim_paired=False, sample_global=sample_global, simulate=simulate,
        simulate_pair=simulate_pair, log_kernel=log_kernel,
        prior_minus_global_lp=prior_minus_global_lp,
        prior_diff_lp=prior_diff_lp, sample_local=sample_local,
        prior_lp=prior_lp, discrepancy=discrepancy, prior_grad=prior_grad)
