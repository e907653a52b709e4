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
one problem serves runs on any device.

The JAX package simulates the default ``y_obs`` of ``GKProblem`` and
``MA2Problem`` from ``theta_true`` with a JAX key, which a torch generator
cannot reproduce; at the default ``num_draws`` and ``theta_true`` the port
carries those values as float32 literals.  Any other ``num_draws`` or
``theta_true``, or any ``key``, needs ``y_obs=``, and without it raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from ..utils.profiling import annotate

__all__ = ["ABCProblem", "MixtureProblem", "HighDimMixtureProblem",
           "GKProblem", "MA2Problem", "initial_chains"]

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

    def shared_redraw_inputs(self, kde, cutoff: float, nan_dis: float):
        """The shared AGLMCMC epoch's K10 constants for this problem and
        ``kde`` (``ops/kernels/shared_redraw_kernel.RedrawInputs``), or
        None where K10's simulator and prior are not this problem's."""
        return None

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


def initial_chains(problem, generator, theta0, num_chains: int = 1, y0=None,
                   device=None):
    """Every chain's initial ``theta (C, d)``, dataset ``y (C, y_dim)`` and
    log kernel value ``(C,)``, the first state of every sampler.

    ``theta0`` ``(d,)`` or ``(1, d)`` broadcasts to ``num_chains`` chains,
    ``(num_chains, d)`` gives each its own.  ``y0`` ``(y_dim,)`` or ``(1,
    y_dim)`` broadcasts, ``(C, y_dim)`` gives each chain its own; ``None``
    simulates each chain's from its theta (``Mixture.py:66``).  The upload
    of ``theta0`` and ``y0`` is a ``glabc.io.h2d`` span with their bytes."""
    dev = resolve_device(device)
    theta0 = np.asarray(theta0, np.float32)
    if y0 is not None:
        y0 = np.asarray(y0, np.float32)
    with annotate("glabc.io.h2d",
                  theta0.nbytes + (0 if y0 is None else y0.nbytes)):
        theta0 = torch.as_tensor(theta0, device=dev)
        if y0 is not None:
            y0 = torch.as_tensor(y0, device=dev)
    theta = theta0.reshape(-1, theta0.shape[-1])
    if theta.shape[0] == 1:
        theta = theta.expand(num_chains, theta.shape[1])
    if theta.shape[0] != num_chains:
        raise ValueError(f"theta0 has {theta.shape[0]} rows for "
                         f"{num_chains} chains")
    theta = theta.contiguous()
    if y0 is None:
        y = problem.simulate(theta, generator)
    else:
        y = y0.reshape(-1, problem.y_dim)
        if y.shape[0] == 1:
            y = y.expand(num_chains, problem.y_dim)
        if y.shape[0] != num_chains:
            raise ValueError(f"y0 has {y.shape[0]} rows for {num_chains} "
                             "chains")
        y = y.contiguous()
    return theta, y, problem.kernel_log_prob(problem.discrepancy(y))


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

    def shared_redraw_inputs(self, kde, cutoff: float, nan_dis: float):
        """K10's constants: the KDE's CDF (``KernelDensity.pick``'s
        cumulative sum), support and bandwidth, and this problem's
        constants as its own functions compute them at 0; None where a
        subclass overrides the simulator, prior, discrepancy or
        epsilon-kernel that K10 computes."""
        from ..ops.kernels.shared_redraw_kernel import RedrawInputs

        cls = type(self)
        if any(getattr(cls, m) is not getattr(_GaussianAbsProblem, m)
               for m in ("simulate", "prior_log_prob", "discrepancy",
                         "kernel_log_prob")):
            return None
        dev = kde.X.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        prior0 = self.prior_log_prob(torch.zeros(kde.dim))
        return RedrawInputs(
            torch.cumsum(kde.weights, dim=-1), kde.X.contiguous(),
            kde.bandwidth.contiguous(), self.y_obs.to(dev),
            self.kernel_log_prob(zero), float(prior0), cutoff,
            self._noise_std, self.epsilon, nan_dis)


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


# The JAX package's default observations: MA2Problem() simulated with
# jax.random.PRNGKey(42) at num_draws=100, GKProblem() with PRNGKey(1234) at
# num_draws=1000 (glabc_tpu/models/problems.py), as float32.
_MA2_Y_OBS_100 = (1.0865206718444824, 0.4801788032054901,
                  -0.01683427393436432)
_GK_Y_OBS_1000 = (2.3917388916015625, 2.568113088607788, 2.768963098526001,
                  3.0102546215057373, 3.480257511138916, 4.471399307250977,
                  6.48219108581543)

# rows of one simulator batch: bounds the memory of a series of innovations
_SIM_CHUNK = 1 << 20


def _default_y_obs(name, y_obs, num_draws, theta_true, key, default_draws,
                   default_theta, literal):
    """``y_obs`` as given, else the JAX package's default dataset, which
    exists only at its ``num_draws`` and ``theta_true`` and its own key."""
    if y_obs is not None:
        return torch.tensor(np.asarray(y_obs, np.float32).reshape(-1))
    simulated = (f"the default y_obs is the JAX package's dataset at "
                 f"num_draws={default_draws}, theta_true={default_theta}, "
                 "simulated with its own jax.random key")
    if key is not None:
        raise ValueError(f"{name}: the port cannot replay jax.random keys "
                         f"({simulated}); pass y_obs= instead of key=")
    if num_draws != default_draws:
        raise ValueError(f"{name}: {simulated}; pass y_obs= for num_draws="
                         f"{num_draws}")
    if not np.array_equal(np.asarray(theta_true, np.float32),
                          np.asarray(default_theta, np.float32)):
        raise ValueError(f"{name}: {simulated}; pass y_obs= for theta_true="
                         f"{tuple(np.asarray(theta_true).tolist())}")
    return torch.tensor(literal, dtype=torch.float32)


def _chunked(fn, theta, n_noise, generator):
    """``fn(theta_rows (N, d), z (N, n_noise))`` over ``theta (..., d)`` in
    chunks of ``_SIM_CHUNK`` rows, each with fresh standard normals."""
    theta = torch.as_tensor(theta, dtype=torch.float32)
    batch = theta.shape[:-1]
    rows = theta.reshape(-1, theta.shape[-1])
    outs = []
    for r0 in range(0, max(rows.shape[0], 1), _SIM_CHUNK):
        th = rows[r0:r0 + _SIM_CHUNK]
        z = torch.randn((th.shape[0], n_noise), generator=generator,
                        dtype=torch.float32, device=theta.device)
        outs.append(fn(th, z))
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return out.reshape(*batch, out.shape[-1])


class GKProblem(ABCProblem):
    """The g-and-k distribution (``glabc_tpu.models.problems.GKProblem``):
    ``Q(z) = A + B (1 + 0.8 tanh(g z / 2)) (1 + z^2)^k z`` on ``num_draws``
    standard normals, summarized by the seven octiles of the sorted draws;
    box-uniform prior on ``[prior_low, prior_high]^4``.  The arguments are
    JAX's, in its order; ``theta_true`` and ``key`` only choose the
    default ``y_obs`` (see :func:`_default_y_obs`)."""

    def __init__(self, epsilon: float = 2.0, num_draws: int = 1000,
                 theta_true=(3.0, 1.0, 2.0, 0.5), prior_low=0.0,
                 prior_high=10.0, y_obs=None, key=None):
        self.epsilon = float(epsilon)
        self.theta_dim = 4
        self.num_draws = int(num_draws)
        self.prior_low = float(prior_low)
        self.prior_high = float(prior_high)
        self.y_obs = _default_y_obs("GKProblem", y_obs, self.num_draws,
                                    theta_true, key, 1000,
                                    (3.0, 1.0, 2.0, 0.5), _GK_Y_OBS_1000)

    def summaries(self, theta, z):
        """The octiles of ``Q(z; theta)``: ``theta (..., 4)``, ``z (...,
        num_draws)`` given standard normals."""
        A, B, g, k = (theta[..., i:i + 1] for i in range(4))
        q = A + B * (1.0 + 0.8 * torch.tanh(g * z / 2.0)) \
            * (1.0 + z * z) ** k * z
        q, _ = torch.sort(q, dim=-1)
        idx = (torch.arange(1, 8, device=q.device) * self.num_draws) // 8
        return q[..., idx]

    def simulate(self, theta, generator=None):
        return _chunked(self.summaries, theta, self.num_draws, generator)

    def prior_log_prob(self, theta):
        theta = torch.as_tensor(theta, dtype=torch.float32)
        inside = torch.all((theta >= self.prior_low)
                           & (theta <= self.prior_high), dim=-1)
        logp = -self.theta_dim * math.log(self.prior_high - self.prior_low)
        return torch.where(inside, torch.full_like(theta[..., 0], logp),
                           torch.full_like(theta[..., 0], -math.inf))

    def prior_grad(self, theta):
        """Zero: the prior is flat on its support (JAX's autodiff of the
        ``where(inside, const, -inf)`` log-prior is zero too)."""
        return torch.zeros_like(torch.as_tensor(theta, dtype=torch.float32))

    def discrepancy(self, y):
        y = torch.as_tensor(y, dtype=torch.float32)
        diff = y - self.y_obs.to(y.device)
        return torch.sqrt(torch.sum(diff * diff, dim=-1))


class MA2Problem(ABCProblem):
    """MA(2) time-series ABC (``glabc_tpu.models.problems.MA2Problem``):
    ``y_t = e_t + theta_1 e_{t-1} + theta_2 e_{t-2}`` with standard normal
    innovations ``e_{-2} .. e_{T-1}``, summarized by the lag-0/1/2
    autocovariances ``s_k = (1/T) sum_t y_t y_{t-k}`` (``y_{t<0} = 0``);
    uniform prior on the triangle ``(-2, 1), (2, 1), (0, -1)``.  Its
    :meth:`tile_program` is the generic fused kernels' program.
    ``theta_true`` and ``key`` choose the default ``y_obs`` as in JAX (see
    :func:`_default_y_obs`)."""

    def __init__(self, epsilon: float = 0.2, num_draws: int = 100,
                 theta_true=(0.6, 0.2), y_obs=None, key=None):
        self.epsilon = float(epsilon)
        self.theta_dim = 2
        self.num_draws = int(num_draws)
        self.theta_true = torch.tensor(theta_true, dtype=torch.float32)
        self.y_obs = _default_y_obs("MA2Problem", y_obs, self.num_draws,
                                    theta_true, key, 100, (0.6, 0.2),
                                    _MA2_Y_OBS_100)

    def summaries(self, theta, z):
        """``(s0, s1, s2)`` of the series driven by the innovations ``z
        (..., num_draws + 2)`` (``z[..., 0]`` is ``e_{-2}``)."""
        T = self.num_draws
        th1, th2 = theta[..., 0:1], theta[..., 1:2]
        y = z[..., 2:] + th1 * z[..., 1:-1] + th2 * z[..., :-2]
        s0 = torch.sum(y * y, dim=-1) / T
        s1 = torch.sum(y[..., 1:] * y[..., :-1], dim=-1) / T
        s2 = torch.sum(y[..., 2:] * y[..., :-2], dim=-1) / T
        return torch.stack([s0, s1, s2], dim=-1)

    def simulate(self, theta, generator=None):
        return _chunked(self.summaries, theta, self.num_draws + 2, generator)

    def prior_log_prob(self, theta):
        theta = torch.as_tensor(theta, dtype=torch.float32)
        th1, th2 = theta[..., 0], theta[..., 1]
        inside = (th2 < 1.0) & (th2 > th1 - 1.0) & (th2 > -th1 - 1.0)
        return torch.where(inside, torch.full_like(th1, -math.log(4.0)),
                           torch.full_like(th1, -math.inf))

    def prior_grad(self, theta):
        """Zero: the prior is flat on its support (JAX's autodiff of the
        ``where(inside, const, -inf)`` log-prior is zero too)."""
        return torch.zeros_like(torch.as_tensor(theta, dtype=torch.float32))

    def discrepancy(self, y):
        y = torch.as_tensor(y, dtype=torch.float32)
        diff = y - self.y_obs.to(y.device)
        return torch.sqrt(torch.sum(diff * diff, dim=-1))

    def tile_program(self, *, lp_scale: float = 0.1):
        """The problem as a :class:`~glabc_tpu_torch.ops.kernels.program.
        TileProgram` for the generic fused kernels."""
        from ..ops.kernels.program import ma2_tile_program
        return ma2_tile_program(self, lp_scale=lp_scale)
