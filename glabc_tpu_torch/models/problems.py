"""ABC problem DSL in torch.

Port of ``glabc_tpu/models/problems.py`` (the reference "ABCset",
``examples/Mixture.py:5-53``).  A problem is an explicit base class of
batch-first functions on tensors; randomness comes from an explicit
``torch.Generator``:

* ``simulate(theta, generator) -> y``  ``(..., d_theta) -> (..., d_y)``
* ``prior_log_prob(theta) -> (...,)``
* ``discrepancy(y) -> (...,)``          distance of simulated data to ``y_obs``
* ``kernel_log_prob(dis, epsilon=None) -> (...,)``

``y_obs`` is kept on the CPU and moved to the argument's device on use, so
one problem serves runs on any device.  ``GKProblem`` and ``MA2Problem`` are
not ported yet (ROADMAP Queue 1, M11).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["ABCProblem", "MixtureProblem", "HighDimMixtureProblem"]

_LOG_2PI = math.log(2.0 * math.pi)


def _gaussian_kernel_log_prob(dis: torch.Tensor, epsilon) -> torch.Tensor:
    """log N(dis; 0, epsilon^2), the reference epsilon-kernel
    (``Mixture.py:38-53``)."""
    epsilon = torch.as_tensor(epsilon, dtype=torch.float32, device=dis.device)
    r = dis / epsilon
    return -0.5 * _LOG_2PI - torch.log(epsilon) - 0.5 * (r * r)


class ABCProblem:
    """Base class.  Subclasses set ``epsilon``, ``theta_dim``, ``y_obs``
    (``(y_dim,)`` float32) and implement ``simulate``, ``prior_log_prob``
    and ``discrepancy``."""

    epsilon: float
    theta_dim: int
    y_obs: torch.Tensor

    @property
    def y_dim(self) -> int:
        return int(self.y_obs.shape[-1])

    def simulate(self, theta: torch.Tensor, generator=None) -> torch.Tensor:
        raise NotImplementedError

    def prior_log_prob(self, theta: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def discrepancy(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def kernel_log_prob(self, dis: torch.Tensor, epsilon=None) -> torch.Tensor:
        if epsilon is None:
            epsilon = self.epsilon
        return _gaussian_kernel_log_prob(dis, epsilon)

    def log_kernel_of_y(self, y: torch.Tensor, epsilon=None) -> torch.Tensor:
        """kernel_log_prob(discrepancy(y)), reference ``calculate_log_kernel``."""
        return self.kernel_log_prob(self.discrepancy(y), epsilon)

    def prior_grad(self, theta: torch.Tensor) -> torch.Tensor:
        """Gradient of the log-prior by autograd."""
        th = torch.as_tensor(theta, dtype=torch.float32).detach()
        th.requires_grad_(True)
        (g,) = torch.autograd.grad(self.prior_log_prob(th).sum(), th)
        return g

    # reference-style aliases
    def generate_samples(self, theta, generator=None, num_samples: int = 1):
        if num_samples == 1:
            return self.simulate(theta, generator)
        th = torch.as_tensor(theta, dtype=torch.float32)
        return self.simulate(th.expand(num_samples, *th.shape), generator)

    def calculate_log_kernel(self, y, epsilon=None):
        return self.log_kernel_of_y(y, epsilon)

    def calculate_log_kernel_dis(self, dis, epsilon=None):
        return self.kernel_log_prob(dis, epsilon)


class _GaussianAbsProblem(ABCProblem):
    """``y = |theta| + sigma z``, prior N(0, I), Euclidean discrepancy."""

    _noise_std: float

    def simulate(self, theta, generator=None):
        theta = torch.as_tensor(theta, dtype=torch.float32)
        noise = torch.randn(theta.shape, generator=generator,
                            dtype=torch.float32, device=theta.device)
        return torch.abs(theta) + self._noise_std * noise

    def prior_log_prob(self, theta):
        theta = torch.as_tensor(theta, dtype=torch.float32)
        return -0.5 * self.theta_dim * _LOG_2PI - 0.5 * torch.sum(
            theta * theta, dim=-1)

    def discrepancy(self, y):
        y = torch.as_tensor(y, dtype=torch.float32)
        diff = y - self.y_obs.to(y.device)
        return torch.sqrt(torch.sum(diff * diff, dim=-1))


class MixtureProblem(_GaussianAbsProblem):
    """The canonical 2-D Gaussian-mixture ABC problem
    (``examples/Mixture.py:5-53``): prior N(0, I_2), simulator
    ``y = |theta| + N(0, 0.05 I_2)`` (0.05 is the variance, so the noise std
    is sqrt(0.05)), discrepancy to ``y_obs = [1.5, 1.5]``."""

    def __init__(self, epsilon: float = 0.05):
        self.epsilon = float(epsilon)
        self.theta_dim = 2
        self.y_obs = torch.tensor([1.5, 1.5], dtype=torch.float32)
        self._noise_std = float(np.sqrt(np.float32(0.05)))


class HighDimMixtureProblem(_GaussianAbsProblem):
    """d-dimensional :class:`MixtureProblem`: prior N(0, I_d), simulator
    ``y = |theta| + sqrt(noise_var) N(0, I_d)``, discrepancy to
    ``y_obs = y_obs_value * 1``."""

    def __init__(self, dim: int = 8, epsilon: float = 0.5,
                 y_obs_value: float = 1.5, noise_var: float = 0.05):
        self.epsilon = float(epsilon)
        self.theta_dim = int(dim)
        self.y_obs = torch.full((self.theta_dim,), float(y_obs_value),
                                dtype=torch.float32)
        self._noise_std = float(np.sqrt(np.float32(noise_var)))
