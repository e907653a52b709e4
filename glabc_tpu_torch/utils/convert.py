"""Carry problems, proposals and fused-kernel state across from the JAX
package, as numpy arrays.

This module imports nothing of ``glabc_tpu``: callers pass the JAX objects'
parameters as numpy (``np.asarray(problem.y_obs)``, ``problem.epsilon``,
``problem._noise_std``, ``np.asarray(dist.loc)``, ...), so both packages can
start from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.distributions import DiagGaussian
from ..models.problems import HighDimMixtureProblem, MixtureProblem

__all__ = ["mixture_problem_from_numpy", "diag_gaussian_from_numpy",
           "state_from_numpy", "state_to_numpy"]


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
