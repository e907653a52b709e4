"""Tile programs and the problems behind them, glabc_tpu_torch against
glabc_tpu, on the CPU.

* The programs' deterministic callables (``log_kernel``,
  ``prior_minus_global_lp``, ``prior_diff_lp``, ``prior_lp``,
  ``discrepancy``, ``prior_grad``) against the JAX program's, called on
  zero-padded ``(8, C)`` tiles with a ``TileLib`` outside any kernel, to
  rtol 1e-6; the -1e30 out-of-support entries exactly.
* The MA(2) simulator (the problem's and the program twin's) fed the
  innovations ``jax.random.normal`` draws, against ``MA2Problem.simulate``
  to 1e-5 max(1, |s|): the two sum in another order.  The g-and-k
  quantile-sort-octile path on the same normals, to 3e-5 relative (XLA's
  tanh and pow are other approximations than torch's; the power amplifies
  their last-bit differences).
* The default ``y_obs`` literals against the JAX problems' draws.
* The ``Draws`` cursor against the blocks it reads; the build keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glabc_tpu
from glabc_tpu.ops.pallas.generic_kernel import TileLib
from glabc_tpu.ops.pallas.generic_kernel import (
    mixture_tile_program as j_mixture_program)
from glabc_tpu_torch import GKProblem, HighDimMixtureProblem, MA2Problem, \
    MixtureProblem
from glabc_tpu_torch.ops.kernels import _build
from glabc_tpu_torch.ops.kernels.philox import Draws, block_uniforms
from glabc_tpu_torch.ops.kernels.program import (NEG, TileProgram,
                                                 mixture_tile_program)
from glabc_tpu_torch.utils.convert import (gk_problem_from_numpy,
                                           ma2_problem_from_numpy,
                                           ma2_program_from_numpy,
                                           mixture_program_from_numpy)

torch.set_num_threads(1)

C = 256


def _pad(x, rows=8):
    """``(k, C)`` numpy -> the JAX ``(rows, C)`` tile, zero below."""
    out = np.zeros((rows, x.shape[1]), np.float32)
    out[:x.shape[0]] = x
    return jnp.asarray(out)


def _programs():
    """(name, port program, JAX program, d, y_rows) of each shipped kind."""
    out = []
    for d in (2, 3):
        jp = (glabc_tpu.MixtureProblem(0.05) if d == 2
              else glabc_tpu.HighDimMixtureProblem(3))
        kw = dict(ip_loc=0.2, ip_scale=1.3, lp_scale=0.35, prior_loc=-0.1,
                  prior_scale=1.1)
        port = mixture_program_from_numpy(np.asarray(jp.y_obs), jp.epsilon,
                                          jp._noise_std, **kw)
        out.append((f"mixture{d}", port, j_mixture_program(jp, **kw), d, d))
    jm = glabc_tpu.MA2Problem(num_draws=16)
    port = ma2_program_from_numpy(np.asarray(jm.y_obs), jm.epsilon, 16)
    out.append(("ma2", port, jm.tile_program(), 2, 3))
    return out


@pytest.mark.parametrize("case", _programs(), ids=lambda c: c[0])
def test_program_callables_match_jax(case):
    name, port, jprog, d, Y = case
    rng = np.random.default_rng(len(name))
    theta = rng.uniform(-2.3, 2.3, (d, C)).astype(np.float32)
    other = rng.uniform(-1.5, 1.5, (d, C)).astype(np.float32)
    y = (rng.normal(0.5, 1.0, (Y, C))).astype(np.float32)
    tl = TileLib(8, C)
    t = torch.from_numpy
    tol = dict(rtol=1e-6, atol=1e-6)
    pairs = [
        ("log_kernel", port.log_kernel(t(y)), jprog.log_kernel(tl, _pad(y))),
        ("prior_minus_global_lp", port.prior_minus_global_lp(t(theta)),
         jprog.prior_minus_global_lp(tl, _pad(theta))),
        ("prior_diff_lp", port.prior_diff_lp(t(theta), t(other)),
         jprog.prior_diff_lp(tl, _pad(theta), _pad(other))),
        ("prior_lp", port.prior_lp(t(theta)),
         jprog.prior_lp(tl, _pad(theta))),
        ("discrepancy", port.discrepancy(t(y)),
         jprog.discrepancy(tl, _pad(y))),
    ]
    for what, a, b in pairs:
        b = np.asarray(b).reshape(-1)
        a = a.numpy()
        neg = b <= -1e29
        np.testing.assert_array_equal(a[neg], b[neg], err_msg=what)
        np.testing.assert_allclose(a[~neg], b[~neg], err_msg=what, **tol)
        if name == "ma2" and what != "log_kernel" and what != "discrepancy":
            assert 0 < neg.sum() < C, what   # both sides of the triangle
            assert np.all(a[neg] == NEG)
    g = port.prior_grad(t(theta)).numpy()
    np.testing.assert_allclose(g, np.asarray(jprog.prior_grad(
        tl, _pad(theta)))[:d], **tol)
    assert port.theta_dim == jprog.theta_dim and port.y_rows == jprog.y_rows


class _GivenNormals:
    """A cursor whose ``normals`` are the given array (the tests' stand-in
    for the Philox cursor)."""

    paired = False

    def __init__(self, z):
        self.z = z

    def normals(self, n):
        assert n == self.z.shape[1]
        return self.z


@pytest.mark.parametrize("T", [16, 100, 37])
def test_ma2_simulator_matches_jax_on_its_innovations(T):
    jprob = glabc_tpu.MA2Problem(num_draws=T)
    prob = ma2_problem_from_numpy(np.asarray(jprob.y_obs), jprob.epsilon, T)
    rng = np.random.default_rng(T)
    theta = rng.uniform([-2.0, -1.0], [2.0, 1.0], (C, 2)).astype(np.float32)
    key = jax.random.PRNGKey(T)
    want = np.asarray(jprob.simulate(key, jnp.asarray(theta)))       # (C, 3)
    z = np.array(jax.random.normal(key, (C, T + 2), jnp.float32))
    tol = 1e-5 * np.maximum(1.0, np.abs(want))
    got = prob.summaries(torch.from_numpy(theta), torch.from_numpy(z))
    assert np.all(np.abs(got.numpy() - want) <= tol)
    twin = prob.tile_program().simulate(torch.from_numpy(theta.T),
                                        _GivenNormals(torch.from_numpy(z)))
    assert np.all(np.abs(twin.numpy().T - want) <= tol)


def test_gk_simulator_matches_jax_on_its_normals():
    jprob = glabc_tpu.GKProblem(num_draws=200)
    prob = gk_problem_from_numpy(np.asarray(jprob.y_obs), jprob.epsilon, 200)
    rng = np.random.default_rng(0)
    theta = rng.uniform(0.5, 4.0, (C, 4)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jprob.simulate(key, jnp.asarray(theta)))
    z = np.array(jax.random.normal(key, (C, 200), jnp.float32))
    got = prob.summaries(torch.from_numpy(theta), torch.from_numpy(z)).numpy()
    # the same order statistics of the same quantile function; XLA's tanh
    # and pow are other approximations than torch's, and (1 + z^2)^k at
    # k up to 4 amplifies their last-bit differences to ~1e-5 relative
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=0)
    assert got.shape == (C, 7)
    lp = prob.prior_log_prob(torch.tensor([[1.0, 1, 1, 1], [11.0, 1, 1, 1]]))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jprob.prior_log_prob(
        jnp.asarray([[1.0, 1, 1, 1], [11.0, 1, 1, 1]]))))


def test_default_y_obs_are_the_jax_datasets():
    np.testing.assert_array_equal(MA2Problem().y_obs.numpy(),
                                  np.asarray(glabc_tpu.MA2Problem().y_obs))
    np.testing.assert_array_equal(GKProblem().y_obs.numpy(),
                                  np.asarray(glabc_tpu.GKProblem().y_obs))
    with pytest.raises(ValueError, match="y_obs"):
        MA2Problem(num_draws=16)
    with pytest.raises(ValueError, match="y_obs"):
        GKProblem(num_draws=100)
    p = MA2Problem(num_draws=16, y_obs=[1.0, 0.5, 0.0])
    assert p.simulate(torch.zeros(5, 4, 2),
                      torch.Generator().manual_seed(0)).shape == (5, 4, 3)
    assert torch.equal(p.prior_grad(torch.ones(3, 2)), torch.zeros(3, 2))
    lp = p.prior_log_prob(torch.tensor([[0.0, 0.0], [0.0, 1.5]]))
    assert lp[0] == -np.log(4.0) and lp[1] == -np.inf


def test_draws_cursor_reads_consecutive_blocks():
    chains = torch.arange(7)
    u = block_uniforms(11, chains, 5, 3, 4)                 # blocks 3..6
    cur = Draws(11, chains, 5, 3)
    assert torch.equal(cur.uniform(), u[:, 0])
    a, b = cur.normal_pair()                                # lanes 1, 2
    r = torch.sqrt(-2.0 * torch.log(u[:, 1]))
    assert torch.allclose(a, r * torch.cos(u[:, 2] * 6.2831855))
    assert torch.equal(cur.uniforms(6), u[:, 3:9])          # crosses a block
    assert cur.blocks_used == 3
    z = Draws(11, chains, 5, 3).normals(5)
    c, s = Draws(11, chains, 5, 3).normal_pairs(3)
    assert torch.equal(z, torch.stack([c, s], -1).reshape(7, 6)[:, :5])
    # per-chain starts: chain i's cursor at block 3 + i
    first = torch.arange(7) + 3
    v = Draws(11, chains, 5, first).uniforms(4)
    for i in range(7):
        assert torch.equal(v[i], block_uniforms(11, chains[i:i + 1], 5,
                                                3 + i, 1)[0])


def test_programs_fit_their_block_budgets():
    """Each random callable reads no more blocks than the program says."""
    prob = MA2Problem(num_draws=37, y_obs=[1.0, 0.4, 0.0])
    for prog in (prob.tile_program(), mixture_tile_program(MixtureProblem()),
                 mixture_tile_program(HighDimMixtureProblem(3))):
        chains = torch.arange(4)
        th = torch.zeros(prog.theta_dim, 4)
        for fn, arg, budget in ((prog.sample_global, (), prog.global_blocks),
                                (prog.sample_local, (th,),
                                 prog.local_blocks),
                                (prog.simulate, (th,), prog.sim_blocks)):
            cur = Draws(0, chains, 0, 0)
            fn(*arg, cur)
            assert cur.blocks_used <= budget, (prog.name, fn)
        assert isinstance(prog, TileProgram)


def test_build_keys_per_program():
    ma2 = MA2Problem(num_draws=16, y_obs=[1.0, 0.4, 0.0]).tile_program()
    ma2b = MA2Problem(epsilon=0.3).tile_program(lp_scale=0.2)
    mix2 = mixture_tile_program(MixtureProblem())
    mix3 = mixture_tile_program(HighDimMixtureProblem(3))
    path = _build.lib_path
    # numbers are launch parameters: one build serves every epsilon / y_obs
    assert path("generic_glmcmc", ma2) == path("generic_glmcmc", ma2b)
    assert path("generic_glmcmc", mix2) != path("generic_glmcmc", mix3)
    assert path("generic_glmcmc", ma2) != path("generic_glmala", ma2)
    assert "ma2" in path("pool_isir_mixed", ma2).name
    assert path("pool_isir_mixed", ma2) != path("pool_isir_mixed")
    assert path("generic_glmcmc", mix2) == path("generic_glmcmc",
                                                _build.SHIPPED[0][1])
    with pytest.raises(ValueError, match="program"):
        path("mixture_glmcmc", ma2)
    with pytest.raises(ValueError):
        path("generic_glmcmc")
    shipped = {(s, k[0]) for s, k in _build.SHIPPED}
    assert shipped == {("generic_glmcmc", "programs/mixture.cuh"),
                       ("generic_glmcmc", "programs/ma2.cuh"),
                       ("generic_glmala", "programs/mixture.cuh"),
                       ("generic_glmala", "programs/ma2.cuh"),
                       ("pool_isir_mixed", "programs/ma2.cuh")}
