"""The MA(2) and g-and-k problem constructors of glabc_tpu_torch against
glabc_tpu's, on the CPU.

The JAX package simulates a problem's default ``y_obs`` from ``theta_true``
with a JAX key; the port carries that one dataset as float32 literals.  So
the port takes JAX's arguments in JAX's order, gives the same problem where
it can (the default dataset, or any ``y_obs=``), and raises ``ValueError``
asking for ``y_obs=`` where it cannot (another ``theta_true`` or
``num_draws``, or a ``key``, without ``y_obs=``).
"""

import jax
import numpy as np
import pytest
import torch

import glabc_tpu
from glabc_tpu_torch import GKProblem, MA2Problem

PROBLEMS = {
    "ma2": (MA2Problem, glabc_tpu.MA2Problem, (-0.5, 0.3),
            [[0.1, 0.2], [0.6, 0.2], [1.5, 0.9], [0.0, -1.5]]),
    "gk": (GKProblem, glabc_tpu.GKProblem, (2.0, 1.5, 1.0, 0.3),
           [[3.0, 1.0, 2.0, 0.5], [-0.5, 1.0, 1.0, 1.0], [4.0, 9.0, 2.0, 0.2],
            [1.0, 1.0, 11.0, 0.1]]),
}


def _agree(port, jprob, thetas):
    """The two problems have the same data, prior and discrepancy."""
    np.testing.assert_array_equal(port.y_obs.numpy(), np.asarray(jprob.y_obs))
    th = np.asarray(thetas, np.float32)
    np.testing.assert_array_equal(
        port.prior_log_prob(torch.from_numpy(th)).numpy(),
        np.asarray(jprob.prior_log_prob(th)))
    y = th[:, :1] + np.linspace(0.0, 1.0, port.y_dim, dtype=np.float32)
    np.testing.assert_allclose(port.discrepancy(torch.from_numpy(y)).numpy(),
                               np.asarray(jprob.discrepancy(y)), rtol=1e-6)


@pytest.mark.parametrize("name", ["ma2", "gk"])
def test_default_problem_matches_jax(name):
    cls, jcls, _, thetas = PROBLEMS[name]
    _agree(cls(), jcls(), thetas)


@pytest.mark.parametrize("name", ["ma2", "gk"])
def test_y_obs_override_with_another_theta_true(name):
    cls, jcls, theta, thetas = PROBLEMS[name]
    jprob = jcls(theta_true=theta)      # JAX simulates y_obs from theta
    port = cls(theta_true=theta, y_obs=np.asarray(jprob.y_obs))
    _agree(port, jprob, thetas)
    # a key is unused when y_obs is given, in JAX and here
    _agree(cls(theta_true=theta, y_obs=np.asarray(jprob.y_obs),
               key=jax.random.PRNGKey(3)), jprob, thetas)


@pytest.mark.parametrize("name", ["ma2", "gk"])
def test_another_theta_true_without_y_obs_raises(name):
    cls, _, theta, _ = PROBLEMS[name]
    with pytest.raises(ValueError, match="pass y_obs= for theta_true"):
        cls(theta_true=theta)
    # the default theta_true, given explicitly, is the default dataset
    default = cls()
    again = cls(theta_true=tuple(np.asarray(
        (0.6, 0.2) if name == "ma2" else (3.0, 1.0, 2.0, 0.5)).tolist()))
    assert torch.equal(again.y_obs, default.y_obs)


@pytest.mark.parametrize("name", ["ma2", "gk"])
def test_key_without_y_obs_raises(name):
    cls = PROBLEMS[name][0]
    with pytest.raises(ValueError, match="pass y_obs= instead of key="):
        cls(key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="y_obs="):
        cls(key=np.array([0, 42], np.uint32))


def test_positional_calls_follow_jax_order():
    # g-and-k: (epsilon, num_draws, theta_true, prior_low, prior_high,
    # y_obs, key)
    p = GKProblem(2.0, 1000, (3.0, 1.0, 2.0, 0.5))
    assert (p.prior_low, p.prior_high) == (0.0, 10.0)
    jprob = glabc_tpu.GKProblem(1.5, 200, (2.0, 1.5, 1.0, 0.3), -1.0, 5.0)
    port = GKProblem(1.5, 200, (2.0, 1.5, 1.0, 0.3), -1.0, 5.0,
                     np.asarray(jprob.y_obs))
    assert (port.epsilon, port.num_draws) == (1.5, 200)
    assert (port.prior_low, port.prior_high) == (-1.0, 5.0)
    _agree(port, jprob, PROBLEMS["gk"][3])
    # MA(2): (epsilon, num_draws, theta_true, y_obs, key)
    jm = glabc_tpu.MA2Problem(0.3, 50, (0.5, 0.1))
    pm = MA2Problem(0.3, 50, (0.5, 0.1), np.asarray(jm.y_obs))
    assert (pm.epsilon, pm.num_draws) == (0.3, 50)
    np.testing.assert_array_equal(pm.theta_true.numpy(),
                                  np.asarray(jm.theta_true))
    _agree(pm, jm, PROBLEMS["ma2"][3])
