"""glabc_tpu_torch distributions and problems held against glabc_tpu.

The same numpy inputs (from a seed) go through both packages' densities; the
deterministic functions must agree to float32 rounding (atol 1e-6 on values
of order 1-100, plus rtol 1e-6 for the larger log-densities).  Samplers are
checked by their moments.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glabc_tpu
import glabc_tpu_torch
from glabc_tpu_torch.utils.convert import (diag_gaussian_from_numpy,
                                           mixture_problem_from_numpy)

torch.set_num_threads(1)

ATOL = 1e-6
RTOL = 1e-6


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port.detach().cpu().numpy()),
                               np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dim,loc,log_scale", [
    (1, 0.0, 0.0), (2, 0.0, float(np.log(0.35))), (3, 1.5, -0.2),
    (8, -0.7, 0.4)])
def test_diag_gaussian_log_prob_and_cdf(dim, loc, log_scale):
    rng = np.random.default_rng(dim)
    z = rng.normal(0.0, 2.0, (64, dim)).astype(np.float32)
    ref = glabc_tpu.DiagGaussian.create(dim, loc, log_scale)
    port = glabc_tpu_torch.DiagGaussian.create(dim, loc, log_scale)
    _close(port.log_prob(torch.from_numpy(z)), ref.log_prob(jnp.asarray(z)))
    _close(port.cdf(torch.from_numpy(z)), ref.cdf(jnp.asarray(z)))


def test_diag_gaussian_from_jax_parameters():
    """utils.convert builds the port's DiagGaussian from the JAX object's
    parameters as numpy."""
    ref = glabc_tpu.DiagGaussian.create(3, [0.1, -0.2, 0.3], [0.0, 0.5, -0.5])
    port = diag_gaussian_from_numpy(np.asarray(ref.loc),
                                    np.asarray(ref.log_scale))
    z = np.random.default_rng(0).normal(size=(32, 3)).astype(np.float32)
    _close(port.log_prob(torch.from_numpy(z)), ref.log_prob(jnp.asarray(z)))


def test_diag_gaussian_sample_and_forward_moments():
    """Sampling uses a torch.Generator, so streams differ from JAX's: the
    draws are checked by their moments (1e5 draws, 5 standard errors)."""
    g = torch.Generator().manual_seed(0)
    dist = glabc_tpu_torch.DiagGaussian.create(2, [1.0, -1.0],
                                               [0.0, float(np.log(0.5))])
    z = dist.sample(100_000, g).numpy().astype(np.float64)
    np.testing.assert_allclose(z.mean(0), [1.0, -1.0], atol=5 * 1.0 / 316)
    np.testing.assert_allclose(z.std(0), [1.0, 0.5], rtol=0.02)
    zf, log_p = dist(1000, g)
    _close(log_p, dist.log_prob(zf))


@pytest.mark.parametrize("dim,low,high", [(1, -2.0, 2.0), (3, -1.0, 4.0)])
def test_uniform_log_prob(dim, low, high):
    rng = np.random.default_rng(1)
    z = rng.uniform(low - 1, high + 1, (64, dim)).astype(np.float32)
    ref = glabc_tpu.models.distributions.Uniform.create(dim, low, high)
    port = glabc_tpu_torch.Uniform.create(dim, low, high)
    _close(port.log_prob(torch.from_numpy(z)), ref.log_prob(jnp.asarray(z)))


def test_gamma_log_prob():
    rng = np.random.default_rng(2)
    z = rng.uniform(-0.5, 6.0, (64, 2)).astype(np.float32)
    ref = glabc_tpu.models.distributions.Gamma.create([2.0, 3.5], [1.0, 0.5])
    port = glabc_tpu_torch.Gamma.create([2.0, 3.5], [1.0, 0.5])
    _close(port.log_prob(torch.from_numpy(z)), ref.log_prob(jnp.asarray(z)),
           atol=1e-5, rtol=1e-6)


def test_gaussian_mixture_log_prob():
    loc = np.array([[-1.5, -1.5], [1.5, 1.5], [0.0, 2.0]], np.float32)
    scale = np.array([[0.5, 0.7], [1.0, 0.3], [0.4, 0.4]], np.float32)
    w = np.array([0.2, 0.5, 0.3], np.float32)
    ref = glabc_tpu.models.distributions.GaussianMixture.create(
        3, 2, loc=loc, scale=scale, weights=w)
    port = glabc_tpu_torch.GaussianMixture.create(3, 2, loc=loc, scale=scale,
                                                  weights=w)
    z = np.random.default_rng(3).normal(0, 2, (64, 2)).astype(np.float32)
    _close(port.log_prob(torch.from_numpy(z)), ref.log_prob(jnp.asarray(z)),
           atol=1e-5)


def _problems(dim):
    if dim == 2:
        return glabc_tpu.MixtureProblem(0.05), glabc_tpu_torch.MixtureProblem(0.05)
    return (glabc_tpu.HighDimMixtureProblem(dim, epsilon=0.5),
            glabc_tpu_torch.HighDimMixtureProblem(dim, epsilon=0.5))


@pytest.mark.parametrize("dim", [2, 3, 8])
def test_problem_densities(dim):
    ref, port = _problems(dim)
    assert port.theta_dim == ref.theta_dim
    assert port._noise_std == ref._noise_std   # sqrt(0.05), as float32
    rng = np.random.default_rng(dim)
    theta = rng.normal(0, 1.5, (64, dim)).astype(np.float32)
    y = (np.abs(theta) + rng.normal(0, 0.3, theta.shape)).astype(np.float32)
    _close(port.prior_log_prob(torch.from_numpy(theta)),
           ref.prior_log_prob(jnp.asarray(theta)))
    dis_p = port.discrepancy(torch.from_numpy(y))
    dis_r = ref.discrepancy(jnp.asarray(y))
    _close(dis_p, dis_r)
    # log K_eps reaches -1e4 at eps=0.05: float32 relative rounding
    _close(port.kernel_log_prob(dis_p), ref.kernel_log_prob(dis_r),
           atol=1e-5, rtol=1e-6)


def test_noise_std_is_sqrt_of_variance():
    """The simulator noise std is sqrt(0.05), not 0.05
    (``glabc_tpu/models/problems.py:103-113``)."""
    port = glabc_tpu_torch.MixtureProblem(0.05)
    assert abs(port._noise_std - np.sqrt(0.05)) < 1e-7
    g = torch.Generator().manual_seed(0)
    y = port.simulate(torch.full((200_000, 2), 1.0), g).numpy()
    np.testing.assert_allclose(y.std(0), np.sqrt(0.05), rtol=0.01)
    np.testing.assert_allclose(y.mean(0), 1.0, atol=0.005)


@pytest.mark.parametrize("dim", [2, 3])
def test_problem_from_jax_parameters(dim):
    """utils.convert rebuilds the problem from the JAX object's numpy
    parameters, with the same densities."""
    ref, _ = _problems(dim)
    port = mixture_problem_from_numpy(np.asarray(ref.y_obs), ref.epsilon,
                                      ref._noise_std)
    assert type(port).__name__ == type(ref).__name__
    y = np.random.default_rng(4).normal(1.5, 0.5, (16, dim)).astype(np.float32)
    _close(port.log_kernel_of_y(torch.from_numpy(y)),
           ref.log_kernel_of_y(jnp.asarray(y)), atol=1e-5)


def test_problem_helpers_match_jax():
    """prior_grad (autograd vs jax.grad) and the reference-style aliases."""
    ref, port = _problems(2)
    theta = np.random.default_rng(6).normal(size=(8, 2)).astype(np.float32)
    _close(port.prior_grad(torch.from_numpy(theta)),
           ref.prior_grad(jnp.asarray(theta)))
    y = np.abs(theta) + 0.1
    _close(port.calculate_log_kernel(torch.from_numpy(y)),
           ref.calculate_log_kernel(jnp.asarray(y)), atol=1e-5)
    _close(port.calculate_log_kernel_dis(torch.tensor([0.1, 0.5]), 0.3),
           ref.calculate_log_kernel_dis(jnp.asarray([0.1, 0.5]), 0.3))
    g = torch.Generator().manual_seed(0)
    assert port.generate_samples(torch.zeros(2), g, num_samples=5).shape == (5, 2)
    assert port.generate_samples(torch.zeros(2), g).shape == (2,)
