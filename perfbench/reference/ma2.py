"""MA(2) time-series ABC under GLMCMC, step by step in plain torch.

The MA(2) example of Marin, Pudlo, Robert & Ryder (2012), "Approximate
Bayesian computational methods", Statistics and Computing 22:1167-1180: a
series ``y_t = e_t + theta_1 e_{t-1} + theta_2 e_{t-2}``, ``t = 0 .. T-1``,
of standard normal innovations, ``T = 100``; a uniform prior on the
invertibility triangle ``(-2, 1), (2, 1), (0, -1)``; autocovariance
summaries.  Departures from the paper, each a setting of the program's
``MA2Problem`` and its tile program:

* the summaries are the lag-0, 1 and 2 autocovariances ``s_k = (1/T) sum_t
  y_t y_{t-k}`` with ``y_{t<0} = 0`` (the paper's lags 1 and 2, with lag 0
  added), so the dataset has 3 rows; the two innovations before the series,
  ``e_{-2}, e_{-1}``, are drawn with it;
* the observed summaries are the program's float32 literals of a series
  simulated at ``theta = (0.6, 0.2)`` (the configuration's ``y_obs``), not
  a series of the paper's;
* the tolerance is a Gaussian epsilon-kernel ``log N(||s - s_obs||; 0,
  epsilon^2)`` on the Euclidean distance, ``epsilon = 0.2``, in place of the
  paper's accept-within-a-quantile rejection step;
* the sampler is GLMCMC (the GL-ABC-MCMC reference's ``GLMCMC.py``): a coin
  picks iSIR over the current state and ``B`` candidates drawn uniformly
  from the box ``[-2, 2] x [-1, 1]`` around the triangle (out-of-triangle
  candidates weigh nothing), or a Gaussian random-walk MH move of scale
  ``lp_scale``.

The random numbers are the port's Philox streams (``philox.py``) in the
generic fused kernel's documented layout (``csrc/generic_glmcmc.cu``): at
absolute step ``s`` chain ``c`` of a run keyed by ``seed`` reads blocks
``(c, s, 0..)``; first ``S = ceil((B + 3) / 4)`` blocks of scalar slots
(slot ``k`` is lane ``k % 4`` of block ``k // 4``: Gumbels ``0`` for the
current state and ``1..B`` for the candidates, ``B + 1`` the local accept
uniform, ``B + 2`` the coin), then candidate ``b``'s proposal at block ``S
+ b G`` (two uniforms) and its simulation's cursor at ``S + b G + gb``, then
the local move's proposal at ``S + B G`` (one Box-Muller pair per dim, its
cos branch) and its simulation's at ``S + B G + lb``.  The MA(2) program
declares ``gb = lb = 1`` and ``sb = ceil(2 ceil((T + 2) / 2) / 4)`` blocks a
simulation, and its simulator does not re-read its proposal's blocks, so
``G = gb + sb`` (``ops/kernels/program.py`` ``ma2_tile_program`` and
``GenericLayout``).  A simulation's cursor gives innovations ``2i`` (cos)
and ``2i + 1`` (sin) from pair ``i`` of consecutive uniforms: ``e_{-2},
e_{-1}, e_0, ...``.  Every float operation is written in the order a
float32 run performs it (the running sums ``s0, s1, s2`` in ``t`` order,
then times ``1/T``), so a sound run agrees with this chain by chain except
where a decision sits on a rounding.  Rows are independent (chain, run)
pairs, each with its own seed, so rows of many runs step together.  The
replay takes a ``dtype``: float32 is what the configuration states; a lower
one is the control.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .mixture import f32, kernel_log_prob
from .philox import gumbel, normal_pair, uniforms

LOG_2PI = math.log(2.0 * math.pi)
NEG = -1.0e30                      # a log density outside the support
LOG_P_MINUS_Q = f32(math.log(2.0))  # prior 1/4 on the triangle, box 1/8
BOX_LO = (-2.0, -1.0)
BOX_WIDTH = (4.0, 2.0)


class Problem(NamedTuple):
    """The problem's constants, float32-rounded."""

    T: int                # length of the series
    y_obs: tuple          # the observed summaries (s0, s1, s2)
    epsilon: float
    c_kern: float         # -0.5 log 2 pi - log epsilon
    eps2: float           # epsilon^2
    inv_t: float          # 1 / T

    @classmethod
    def create(cls, num_draws, y_obs, epsilon) -> "Problem":
        T = int(num_draws)
        return cls(T, tuple(f32(v) for v in y_obs), f32(epsilon),
                   f32(-0.5 * LOG_2PI - math.log(epsilon)),
                   f32(epsilon * epsilon), f32(1.0 / T))

    @classmethod
    def from_config(cls, problem: dict) -> "Problem":
        return cls.create(problem["num_draws"], problem["y_obs"],
                          problem["epsilon"])

    @property
    def n_innov(self) -> int:
        return self.T + 2

    @property
    def sim_blocks(self) -> int:
        """Philox blocks a simulation's cursor spans: its pairs' uniforms."""
        return -(-(2 * -(-self.n_innov // 2)) // 4)


class Moves(NamedTuple):
    """The sampler's settings (float32-rounded) and the step's block
    layout."""

    B: int
    gf: float
    lp_scale: float
    S: int                # blocks of scalar slots
    G: int                # blocks of one candidate: proposal + simulation

    @classmethod
    def create(cls, pb: Problem, batch_size, global_frequency,
               lp_scale) -> "Moves":
        B = int(batch_size)
        return cls(B, f32(global_frequency), f32(lp_scale), -(-(B + 3) // 4),
                   1 + pb.sim_blocks)


@functools.lru_cache(maxsize=None)
def _on(values, dtype, device) -> torch.Tensor:
    """A constant on ``device``, made once: a copy from the host would wait
    for the device at every step."""
    return torch.tensor(values, dtype=dtype, device=device)


def _const(x: torch.Tensor, v) -> torch.Tensor:
    """``v`` (a number or a tuple) in ``x``'s dtype on ``x``'s device."""
    return _on(v, x.dtype, x.device)


def inside(theta: torch.Tensor) -> torch.Tensor:
    """``theta (..., 2)`` inside the prior triangle."""
    t1, t2 = theta[..., 0], theta[..., 1]
    return (t2 < 1.0) & (t2 > t1 - 1.0) & (t2 > -t1 - 1.0)


def support_lp(theta: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` inside the triangle, :data:`NEG` outside."""
    return torch.where(inside(theta), _const(theta, value),
                       _const(theta, NEG))


def innovations(u: torch.Tensor, T: int) -> torch.Tensor:
    """``T + 2`` innovations from a cursor's uniforms ``u (..., >= 2
    ceil((T + 2) / 2))``, time first: ``(T + 2, ...)``."""
    n = T + 2
    pairs = u[..., :2 * -(-n // 2)]
    cos, sin = normal_pair(pairs[..., 0::2], pairs[..., 1::2])
    e = torch.stack([cos, sin], dim=-1).flatten(-2)[..., :n]
    return e.movedim(-1, 0)


def summaries(pb: Problem, theta: torch.Tensor, e: torch.Tensor
              ) -> torch.Tensor:
    """The series at ``theta (..., 2)`` on innovations ``e (T + 2, ...)``
    summarised: ``(..., 3)``, the running sums taken in ``t`` order."""
    t1, t2 = theta[..., 0], theta[..., 1]
    y = (e[2:] + t1 * e[1:-1]) + t2 * e[:-2]              # (T, ...)
    zero = torch.zeros_like(y[:2])
    y1 = torch.cat([zero[:1], y[:-1]])                     # y_{t-1}
    y2 = torch.cat([zero, y[:-2]])                         # y_{t-2}
    prods = torch.stack([y * y, y * y1, y * y2], dim=-1)   # (T, ..., 3)
    s = prods[0]
    for t in range(1, pb.T):
        s = s + prods[t]
    return s * pb.inv_t


def log_kernel(pb: Problem, s: torch.Tensor) -> torch.Tensor:
    """The epsilon-kernel of summaries ``s (..., 3)`` as a transition
    computes it: ``c_kern - (0.5 ||s - s_obs||^2) / epsilon^2``, the
    squares summed left to right."""
    diff = s - _const(s, pb.y_obs)
    sq = diff * diff
    dis2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    return pb.c_kern - (0.5 * dis2) / _const(dis2, pb.eps2)


def initial_log_kernel(pb: Problem, y0: torch.Tensor) -> torch.Tensor:
    """The starting state's log-kernel: ``log N(||y0 - y_obs||; 0,
    epsilon^2)``."""
    diff = y0 - torch.tensor(pb.y_obs, dtype=y0.dtype, device=y0.device)
    dis = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return kernel_log_prob(dis, torch.tensor(pb.epsilon, dtype=torch.float32,
                                             device=y0.device))


def simulate(pb: Problem, seed, chain: torch.Tensor, step: int,
             theta: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Summaries of one series a row at ``theta (R, 2)``, its cursor at
    block 0 of step ``step`` of rows ``chain (R,)`` keyed by ``seed``."""
    u = uniforms(seed, chain, step, pb.sim_blocks).to(dtype)
    return summaries(pb, theta.to(dtype), innovations(u, pb.T))


def step_noise(pb: Problem, mv: Moves, seed, chain, step, dtype):
    """One step's draws for rows ``chain`` (see the module docstring):
    Gumbels ``(R, B + 1)``, the local accept uniform and the coin ``(R,)``,
    the candidates' box uniforms ``(R, B, 2)``, the local move's normals
    ``(R, 2)`` and the innovations of the ``B`` candidates' and the local
    move's simulations, ``(T + 2, B + 1, R)``."""
    B, R = mv.B, chain.shape[0]
    u = uniforms(seed, chain, step, mv.S + (B + 1) * mv.G)
    sc = u[:, :B + 3].to(dtype)
    slots = u[:, 4 * mv.S:].reshape(R, B + 1, 4 * mv.G).to(dtype)
    n_local, _ = normal_pair(slots[:, B, 0:4:2], slots[:, B, 1:4:2])
    e = innovations(slots[:, :, 4:], pb.T).transpose(1, 2)
    return (gumbel(sc[:, :B + 1]), sc[:, B + 1], sc[:, B + 2],
            slots[:, :B, :2], n_local, e)


def transition(pb: Problem, mv: Moves, state, noise):
    """One GLMCMC step of every row, both moves computed and the coin's
    kept.  Returns the new state and the increments ``(global attempt,
    global accept, local accept)``."""
    theta, y, logk = state
    g, u_local, u_coin, u_box, n_local, e = noise
    B = mv.B
    cand = _const(u_box, BOX_LO) + _const(u_box, BOX_WIDTH) * u_box
    #                                                            (R, B, 2)
    thl = theta + mv.lp_scale * n_local                        # (R, 2)
    th_all = torch.cat([cand, thl[:, None]], dim=1)            # (R, B+1, 2)
    s_all = summaries(pb, th_all.transpose(0, 1), e)           # (B+1, R, 3)
    lk_all = log_kernel(pb, s_all)                             # (B+1, R)
    # iSIR as a streaming Gumbel-argmax; strict > keeps the earlier on ties
    best = (support_lp(theta, LOG_P_MINUS_Q) + logk) + g[:, 0]
    w_th, w_y, w_lk = theta, y, logk
    w_moved = torch.zeros_like(u_coin, dtype=torch.bool)
    for b in range(B):
        score = ((support_lp(cand[:, b], LOG_P_MINUS_Q) + lk_all[b])
                 + g[:, b + 1])
        upd = score > best
        best = torch.where(upd, score, best)
        w_th = torch.where(upd[:, None], cand[:, b], w_th)
        w_y = torch.where(upd[:, None], s_all[b], w_y)
        w_lk = torch.where(upd, lk_all[b], w_lk)
        w_moved = w_moved | upd
    # local random-walk MH; the current state is inside the triangle
    l_acc = (torch.log(u_local)
             < (support_lp(thl, 0.0) + lk_all[B]) - logk)
    is_g = u_coin < mv.gf
    new = (torch.where(is_g[:, None], w_th,
                       torch.where(l_acc[:, None], thl, theta)),
           torch.where(is_g[:, None], w_y,
                       torch.where(l_acc[:, None], s_all[B], y)),
           torch.where(is_g, w_lk, torch.where(l_acc, lk_all[B], logk)))
    return new, (is_g, is_g & w_moved, ~is_g & l_acc)


def replay(pb: Problem, mv: Moves, seeds: torch.Tensor, chain: torch.Tensor,
           theta0: torch.Tensor, y0: torch.Tensor, steps: int,
           dtype=torch.float32):
    """``steps`` transitions (absolute steps ``0 .. steps - 1``) of rows
    ``(seeds (R,), chain (R,))`` from ``theta0 (R, 2), y0 (R, 3)``.
    Returns ``(theta, y, logk, [global attempts, global accepts, local
    accepts])`` with int64 counts; the state is computed in ``dtype`` and
    returned as float32."""
    logk = initial_log_kernel(pb, y0.to(torch.float32))
    state = (theta0.to(dtype), y0.to(dtype), logk.to(dtype))
    counts = [torch.zeros(chain.shape[0], dtype=torch.int64,
                          device=chain.device) for _ in range(3)]
    for s in range(steps):
        state, inc = transition(pb, mv, state,
                                step_noise(pb, mv, seeds, chain, s, dtype))
        counts = [c + i.to(torch.int64) for c, i in zip(counts, inc)]
    return (*(x.to(torch.float32) for x in state), counts)
