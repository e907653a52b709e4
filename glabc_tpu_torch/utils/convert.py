"""Carry problems, proposals, KDEs, pools and fused-kernel state across
from the JAX package, as numpy arrays.

This module imports nothing of ``glabc_tpu``: callers pass the JAX objects'
parameters as numpy (``np.asarray(problem.y_obs)``, ``problem.epsilon``,
``problem._noise_std``, ``np.asarray(dist.loc)``, ...), so both packages can
start from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.distributions import DiagGaussian
from ..models.kde import KernelDensity
from ..models.problems import HighDimMixtureProblem, MixtureProblem
from ..ops.kernels.pool_isir_mixed_kernel import ResidentProposal
from ..samplers.aglmcmc import Pool

__all__ = ["mixture_problem_from_numpy", "diag_gaussian_from_numpy",
           "state_from_numpy", "state_to_numpy", "kde_from_numpy",
           "pool_from_numpy", "resident_from_numpy", "pool_slice_from_numpy",
           "agl_state_from_numpy"]


def _f32(x, device):
    return torch.tensor(np.asarray(x, np.float32), device=device).contiguous()


def mixture_problem_from_numpy(y_obs, epsilon: float, noise_std: float):
    """A :class:`MixtureProblem` (d=2) or :class:`HighDimMixtureProblem` with
    exactly these ``y_obs``, ``epsilon`` and simulator noise std."""
    y_obs = np.asarray(y_obs, np.float32).reshape(-1)
    if y_obs.shape[0] == 2:
        prob = MixtureProblem(float(epsilon))
    else:
        prob = HighDimMixtureProblem(dim=y_obs.shape[0], epsilon=float(epsilon))
    prob.y_obs = torch.from_numpy(y_obs.copy())
    prob._noise_std = float(noise_std)
    return prob


def diag_gaussian_from_numpy(loc, log_scale, device=None) -> DiagGaussian:
    loc = np.asarray(loc, np.float32).reshape(-1)
    log_scale = np.asarray(log_scale, np.float32).reshape(-1)
    return DiagGaussian(torch.tensor(loc, device=device),
                        torch.tensor(log_scale, device=device))


def state_from_numpy(state, device) -> tuple:
    """A fused state ``(theta, y, logk)`` as numpy, in the packed or the
    unpacked layout, -> contiguous float32 tensors on ``device`` (layout
    kept)."""
    return tuple(torch.tensor(np.asarray(x, np.float32), device=device)
                 .contiguous() for x in state)


def state_to_numpy(state) -> tuple:
    return tuple(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x) for x in state)


def kde_from_numpy(X, weights, bandwidth, device=None) -> KernelDensity:
    """A :class:`KernelDensity` from the JAX one's ``X``, ``weights`` and
    ``bandwidth`` (chain-batched or not)."""
    return KernelDensity(_f32(X, device), _f32(weights, device),
                         _f32(bandwidth, device))


def pool_from_numpy(theta, x, dis, log_q, log_w, device=None) -> Pool:
    """A :class:`Pool` from the JAX ``Pool``'s five ``(C, P, ...)``
    arrays."""
    return Pool(*(_f32(a, device) for a in (theta, x, dis, log_q, log_w)))


def resident_from_numpy(mu_scaled, pre, inv2h, d: int,
                        device=None) -> ResidentProposal:
    """The JAX ``ResidentProposal`` (``(n_pad, d_pad)``, ``(n_pad, 1)``,
    ``(d_pad, 1)``) without its padding: the ``d`` live columns and the
    rows whose ``pre`` is not the -1e30 pad sentinel."""
    pre = np.asarray(pre, np.float32).reshape(-1)
    live = pre > -1.0e29
    return ResidentProposal(
        _f32(np.asarray(mu_scaled, np.float32)[live, :d], device),
        _f32(pre[live], device),
        _f32(np.asarray(inv2h, np.float32).reshape(-1)[:d], device))


def pool_slice_from_numpy(pool_theta, pool_logw, d: int, B: int,
                          device=None):
    """The JAX kernels' pool layout (theta ``(T, B, d_pad, C)``, log-weights
    ``(T, 8, C)``) -> the port's (``(T, B, d, C)``, ``(T, B, C)``)."""
    return (_f32(np.asarray(pool_theta)[:, :, :d, :], device),
            _f32(np.asarray(pool_logw)[:, :B, :], device))


def agl_state_from_numpy(tile, d: int, device=None):
    """A JAX fused AGLMCMC state tile (``(d_pad, C)`` theta or y, or a
    ``(1, C)`` row) -> the port's ``(d, C)`` or ``(C,)``."""
    x = np.asarray(tile, np.float32)
    return _f32(x[0] if x.shape[0] == 1 else x[:d], device)
