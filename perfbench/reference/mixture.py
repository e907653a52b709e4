"""The 2-D Mixture problem of the GL-ABC-MCMC examples, in plain torch.

``examples/Mixture.py:5-53`` of caofff/GL-ABC-MCMC: prior N(0, I_d),
simulator ``y = |theta| + N(0, 0.05 I_d)`` (0.05 is the variance),
Euclidean discrepancy to ``y_obs``, Gaussian epsilon-kernel
``log N(dis; 0, epsilon^2)``.  The constants are rounded to float32 once, as
a float32 run receives them.  Every function takes a ``dtype``: float32 is
what the configuration states; a lower one is the control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)


def f32(x) -> float:
    return float(np.float32(x))


class Problem(NamedTuple):
    """The problem's constants, float32-rounded."""

    d: int
    y_obs: tuple
    epsilon: float
    sigma: float          # simulator noise standard deviation
    c_prior: float        # log N(0; 0, 1) per dimension
    c_kern: float         # -0.5 log 2 pi - log epsilon
    a_kern: float         # 0.5 / epsilon^2

    @classmethod
    def create(cls, d, y_obs, epsilon, noise_var) -> "Problem":
        y = np.broadcast_to(np.asarray(y_obs, np.float32).reshape(-1), (d,))
        return cls(int(d), tuple(float(v) for v in y), f32(epsilon),
                   f32(np.sqrt(np.float32(noise_var))), f32(-0.5 * LOG_2PI),
                   f32(-0.5 * LOG_2PI - math.log(epsilon)),
                   f32(0.5 / (epsilon * epsilon)))

    @classmethod
    def from_config(cls, problem: dict) -> "Problem":
        return cls.create(problem["theta_dim"], problem["y_obs"],
                          problem["epsilon"], problem["noise_var"])

    def y_obs_t(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.y_obs, dtype=like.dtype, device=like.device)


def sum_dims(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right."""
    s = x[..., 0]
    for j in range(1, x.shape[-1]):
        s = s + x[..., j]
    return s


def gauss_lp(th, loc, inv_scale, c):
    """Diagonal Gaussian log-density, summed over dims left to right."""
    z = (th - loc) * inv_scale
    return sum_dims(c - 0.5 * (z * z))


def prior_lp(pb: Problem, th):
    return gauss_lp(th, 0.0, 1.0, pb.c_prior)


def kern_lp(pb: Problem, y):
    """The epsilon-kernel of a dataset as a transition computes it."""
    diff = y - pb.y_obs_t(y)
    return pb.c_kern - sum_dims(diff * diff) * pb.a_kern


def discrepancy(pb: Problem, y):
    diff = y - pb.y_obs_t(y)
    return torch.sqrt(torch.sum(diff * diff, dim=-1))


def kernel_log_prob(dis, epsilon):
    """``log N(dis; 0, epsilon^2)``, epsilon a float or a tensor."""
    eps = torch.as_tensor(epsilon, dtype=dis.dtype, device=dis.device)
    r = dis / eps
    return -0.5 * LOG_2PI - torch.log(eps) - 0.5 * (r * r)


def prior_log_prob(th):
    """``log N(theta; 0, I)`` over the last axis."""
    d = th.shape[-1]
    return -0.5 * d * LOG_2PI - 0.5 * torch.sum(th * th, dim=-1)
