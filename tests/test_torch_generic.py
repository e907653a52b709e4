"""The generic TileProgram path in glabc_tpu_torch held against glabc_tpu,
on the CPU.

* K8, K9 and K5's program variant: the plain versions against the Pallas
  kernels in interpret mode, where every PRNG bit is 0, so every uniform
  is 2^-25 and every Box-Muller pair the same ``(r cos, r sin)``.  The
  plain versions take their draws from a cursor factory; the tests give
  them a stub with that stream, whose MA(2) innovations come in JAX's
  order (the warm-up pair, then 8 cos and 8 sin per 16 steps, then cos).
  Both programs, d=2 and d=3 for the Mixture, both algorithms (K8), both
  coin modes (K9), the coin forced each way by ``global_frequency`` 0.9 /
  0 (K8, K5) or by shared coins (K9): states, datasets and kernel values
  to 1e-5, counters exactly; K9's gradient to 1e-3 absolute (it divides a
  difference of log-densities of ~50 by 2 fd, and under the stub every
  replicate is the same, so the ddof=1 variance is rounding alone).
* The stub's MA(2) box candidate is (-2, -1), outside the prior triangle,
  so there no MA(2) candidate ever wins.  The global move K8 and K9 share
  (``isir_global``) is also held, on non-constant uniforms, innovations and
  Gumbels, against the JAX program's callables fed the same numbers outside
  any kernel and the Pallas kernel's Gumbel-argmax written out in jnp:
  candidates win on some chains and not on others.
* Determinism within the port: ``block_chains``, ``steps_per_call`` and
  segmenting give bitwise-identical chains, and a resumed run continues
  bitwise, for ``run_fused_program``, ``run_glmala_program`` and the MA(2)
  ``run_aglmcmc_fused_mixed``.
* Statistics: ``run_fused_program`` and ``run_glmala_program`` (plain, MA(2)
  at num_draws=16) against JAX's scan ``run_glmcmc`` / ``run_glmala``
  (uniform box importance proposal), within limits set from the seed
  spread of each side (``SLICE``; ``PYTHONPATH=. JAX_PLATFORMS=cpu python
  tests/test_torch_generic.py 5`` prints it).
* The runner's ``tile_program=`` routes and their errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glabc_tpu
from glabc_tpu.ops.pallas.generic_glmala_kernel import (
    GenericFusedGLMALA as JGLMALA)
from glabc_tpu.ops.pallas.generic_kernel import (
    GenericFusedGLMCMC as JGLMCMC, TileLib,
    mixture_tile_program as j_mixture_program)
from glabc_tpu.ops.pallas.pool_isir_kernel import (
    pack_pool_logw as j_pack_logw, pack_pool_theta as j_pack_theta)
from glabc_tpu.ops.pallas.pool_isir_mixed_kernel import (
    PoolISIRMixed as JMixed, resident_from_gaussian as j_res_gauss)
from glabc_tpu_torch import (DiagGaussian, MCMCRunner, Uniform,
                             run_aglmcmc_fused_mixed, run_fused_program,
                             run_glmala_program)
from glabc_tpu_torch.ops.kernels import (GenericFusedGLMALA,
                                         GenericFusedGLMCMC, PoolISIRMixed,
                                         resident_from_gaussian)
from glabc_tpu_torch.ops.kernels.philox import normal_pair
import glabc_tpu_torch.samplers.fused_program as fused_program
from glabc_tpu_torch.utils.convert import (ma2_problem_from_numpy,
                                           ma2_program_from_numpy,
                                           mixture_program_from_numpy)

torch.set_num_threads(1)

U0 = 2.0 ** -25          # interpret mode's every uniform
C = 128


class _Stub:
    """Interpret mode's stream: constant uniforms and pairs; MA(2)
    innovations in the JAX program's order."""

    def __init__(self, n, paired=False):
        self.n, self.paired = n, paired
        u = torch.full((n,), U0)
        self.rc, self.rs = normal_pair(u, u)

    def uniforms(self, k):
        return torch.full((self.n, k), U0)

    def uniform(self):
        return self.uniforms(1)[:, 0]

    def normal_pair(self):
        return self.rc, self.rs

    def normal_pairs(self, k):
        return (self.rc[:, None].expand(self.n, k),
                self.rs[:, None].expand(self.n, k))

    def normals(self, k):
        T = k - 2
        seq = ([self.rc, self.rs] + ([self.rc] * 8 + [self.rs] * 8) * (T // 16)
               + [self.rc] * (T % 16))
        return torch.stack(seq, 1)


def _stub_draws(step, first, paired=False):
    n = C * (first.shape[0] if isinstance(first, torch.Tensor) else 1)
    return _Stub(n, paired)


def _case(name, eps=None):
    """(JAX problem, JAX program, port program, d, y_rows)."""
    if name.startswith("mixture"):
        d = int(name[-1])
        e = 0.05 if eps is None else eps
        jp = (glabc_tpu.MixtureProblem(e) if d == 2
              else glabc_tpu.HighDimMixtureProblem(d, epsilon=e))
        port = mixture_program_from_numpy(np.asarray(jp.y_obs), jp.epsilon,
                                          jp._noise_std)
        return jp, j_mixture_program(jp), port, d, d
    jp = glabc_tpu.MA2Problem(epsilon=0.2 if eps is None else eps,
                              num_draws=16)
    port = ma2_program_from_numpy(np.asarray(jp.y_obs), jp.epsilon, 16)
    return jp, jp.tile_program(), port, 2, 3


def _pad(x):
    return jnp.zeros((8, x.shape[1]), jnp.float32).at[:x.shape[0]].set(x)


def _start(port, d, Y, y_mean, seed=0):
    """States far from y_obs, so that candidates and local moves win."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-0.3, 0.3, (d, C)).astype(np.float32)
    y = rng.normal(y_mean, 0.5, (Y, C)).astype(np.float32)
    lk = port.log_kernel(torch.from_numpy(y)).numpy()
    return th, y, lk, rng


def _close(got, want, what, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


# -------------------------------------------------------------------- K8
@pytest.mark.parametrize("name", ["mixture2", "mixture3", "ma2"])
@pytest.mark.parametrize("algorithm", ["glmcmc", "global"])
@pytest.mark.parametrize("gf", [0.9, 0.0])
def test_k8_plain_matches_pallas_interpret(name, algorithm, gf):
    T, B = 3, 2
    jp, jprog, port, d, Y = _case(name)
    th, y, lk, _ = _start(port, d, Y, 8.0 if name != "ma2" else 200.0)
    jk = JGLMCMC(jprog, global_frequency=gf, batch_size=B, steps_per_call=T,
                 block_chains=128, interpret=True, algorithm=algorithm)
    out = jk.run(jnp.int32(3), _pad(th), _pad(y), jnp.asarray(lk)[None])
    kern = GenericFusedGLMCMC(port, global_frequency=gf, batch_size=B,
                              steps_per_call=T, algorithm=algorithm)
    t = torch.from_numpy
    got = kern.plain(0, t(th), t(y), t(lk), draws=_stub_draws)
    _close(got[0].numpy(), np.asarray(out[0])[:d], "theta")
    _close(got[1].numpy(), np.asarray(out[1])[:Y], "y")
    _close(got[2].numpy(), np.asarray(out[2])[0], "logk")
    _close(got[3].numpy(), np.asarray(out[3])[:, :d], "history")
    for a, b in zip(got[4], out[4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[0])
    moved = float(got[4].accepted.sum())
    if name == "ma2" and gf > 0:
        # the stub's candidate lies outside the triangle: the MA(2) global
        # move with winners is test_ma2_isir_move_matches_jax_callables
        assert moved == 0
    else:
        assert moved > 0


class _Given:
    """A cursor handing out given uniforms ``(C, 2)`` or innovations
    ``(C, n)``."""

    paired = False

    def __init__(self, u=None, z=None):
        self.u, self.z = u, z

    def uniforms(self, k):
        assert k == self.u.shape[1]
        return self.u

    def normals(self, n):
        assert n == self.z.shape[1]
        return self.z


def test_ma2_isir_move_matches_jax_callables(monkeypatch):
    import glabc_tpu.ops.pallas.generic_kernel as jgk
    from glabc_tpu_torch.ops.kernels.generic_kernel import (GenericLayout,
                                                            isir_global)

    B, n = 4, 16
    jp, jprog, port, d, Y = _case("ma2")
    rng = np.random.default_rng(11)
    th = rng.uniform(-0.3, 0.3, (d, C)).astype(np.float32)
    # every other chain's dataset near y_obs (hard to beat), the rest far
    y = (np.asarray(jp.y_obs, np.float32)[:, None]
         + rng.normal(0.0, 0.05, (Y, C)).astype(np.float32))
    y[:, 1::2] += 1.0
    lk = port.log_kernel(torch.from_numpy(y)).numpy()
    u_box = rng.uniform(size=(B, C, 2)).astype(np.float32)
    z = rng.normal(size=(B, C, n + 2)).astype(np.float32)
    u = rng.uniform(1e-4, 1.0 - 1e-4, (C, B + 3)).astype(np.float32)

    # the port: the shared move on cursors that hand out these numbers
    lay = GenericLayout(port, B, True)
    given = {}
    for b in range(B):
        given[lay.candidate(b)] = _Given(u=torch.from_numpy(u_box[b]))
        given[lay.candidate(b) + lay.g_sim] = _Given(z=torch.from_numpy(z[b]))
    t = torch.from_numpy
    got = isir_global(port, lay, B, lambda step, first, paired=False:
                      given[first], 0, t(u), t(th), t(y), t(lk))

    # JAX: the program's callables on the same numbers, the kernel's argmax
    tl = TileLib(8, C)
    gum = lambda v: -jnp.log(-jnp.log(jnp.asarray(v)[None]))
    w_th, w_y, w_lk = _pad(th), _pad(y), jnp.asarray(lk)[None]
    best = jprog.prior_minus_global_lp(tl, w_th) + w_lk + gum(u[:, 0])
    w_mv = jnp.zeros((1, C), bool)
    for b in range(B):
        box = np.full((8, C), 0.5, np.float32)
        box[:2] = u_box[b].T
        monkeypatch.setattr(jgk, "_uniform", lambda shape: jnp.asarray(box))
        warm = (jnp.asarray(z[b][:, 0])[None], jnp.asarray(z[b][:, 1])[None])
        blk = (jnp.asarray(z[b][:, 2:10].T), jnp.asarray(z[b][:, 10:18].T))
        monkeypatch.setattr(jgk, "_normal_pair",
                            lambda shape: warm if shape[0] == 1 else blk)
        thp = jprog.sample_global(tl)
        yp = jprog.simulate(tl, thp)
        lkp = jprog.log_kernel(tl, yp)
        score = jprog.prior_minus_global_lp(tl, thp) + lkp + gum(u[:, b + 1])
        upd = score > best
        best = jnp.where(upd, score, best)
        w_th, w_y = jnp.where(upd, thp, w_th), jnp.where(upd, yp, w_y)
        w_lk, w_mv = jnp.where(upd, lkp, w_lk), w_mv | upd
    want_y = np.asarray(w_y)[:Y]
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(w_mv)[0])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(w_th)[:d])
    assert np.all(np.abs(got[1].numpy() - want_y)
                  <= 1e-5 * np.maximum(1.0, np.abs(want_y)))
    _close(got[2].numpy(), np.asarray(w_lk)[0], "logk")
    moved = got[3].numpy()
    assert 0 < moved[0::2].sum() < moved[1::2].sum() < C // 2


# -------------------------------------------------------------------- K9
@pytest.mark.parametrize("name", ["mixture2", "mixture3", "ma2"])
@pytest.mark.parametrize("coin_mode,coins", [("shared", [0, 1, 0, 0]),
                                             ("per_chain", [0, 0, 0, 0])])
def test_k9_plain_matches_pallas_interpret(name, coin_mode, coins):
    T, B = 4, 2
    # an epsilon far above the stub's rounding noise in the variance
    jp, jprog, port, d, Y = _case(name, eps=0.5 if name != "ma2" else 50.0)
    th, y, lk, rng = _start(port, d, Y, 8.0 if name != "ma2" else 200.0)
    grad = rng.normal(0, 1, (d, C)).astype(np.float32)
    kw = dict(global_frequency=0.8, batch_size=B, tau=0.1, num_grad=4,
              fd_step=0.1, steps_per_call=T, coin_mode=coin_mode)
    jk = JGLMALA(jprog, epsilon=jp.epsilon, block_chains=128, interpret=True,
                 **kw)
    out = jk.run(jnp.int32(3), jnp.asarray(coins, jnp.int32), _pad(th),
                 _pad(y), jnp.asarray(lk)[None], _pad(grad))
    kern = GenericFusedGLMALA(port, epsilon=jp.epsilon, **kw)
    t = torch.from_numpy
    got = kern.plain(0, t(th), t(y), t(lk), t(grad),
                     torch.tensor(coins, dtype=torch.int32),
                     draws=_stub_draws)
    _close(got[0].numpy(), np.asarray(out[0])[:d], "theta")
    _close(got[1].numpy(), np.asarray(out[1])[:Y], "y")
    _close(got[2].numpy(), np.asarray(out[2])[0], "logk")
    np.testing.assert_allclose(got[3].numpy(), np.asarray(out[3])[:d],
                               rtol=0, atol=1e-3, err_msg="grad")
    _close(got[4].numpy(), np.asarray(out[4])[:, :d], "history")
    for a, b in zip(got[5], out[5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[0])
    if coin_mode == "shared":          # local MALA moves are accepted
        assert float(got[5][3].sum()) > 0
        assert not np.allclose(got[3].numpy(), grad)
    else:                              # the stub's coin: every step global
        assert float(got[5][1].min()) == T


# ------------------------------------------------------ K5, program move
@pytest.mark.parametrize("gf", [0.5, 0.0])
def test_k5_program_plain_matches_pallas_interpret(gf):
    T, B, d, Y = 4, 3, 2, 3
    jp, jprog, port, _, _ = _case("ma2")
    th, y, lk, rng = _start(port, d, Y, 200.0)
    P = T * B
    theta_p = rng.uniform([-2.0, -1.0], [2.0, 1.0], (C, P, d)).astype(
        np.float32)
    x_p = rng.normal(0.5, 0.5, (C, P, Y)).astype(np.float32)
    logw_p = rng.normal(-3.0, 2.0, (C, P)).astype(np.float32)
    logk_p = rng.normal(-20.0, 2.0, (C, P)).astype(np.float32)
    jk = JMixed(d, None, epsilon=jp.epsilon, global_frequency=gf,
                batch_size=B, steps_per_call=T, block_chains=128,
                n_support=8, support_chunk=8, collect_history=True,
                interpret=True, program=jprog)
    jpool = (j_pack_theta(jnp.asarray(theta_p), T, B, 8),
             j_pack_theta(jnp.asarray(x_p), T, B, 8),
             j_pack_logw(jnp.asarray(logw_p), T, B),
             j_pack_logw(jnp.asarray(logk_p), T, B))
    loc, scale = np.array([0.1, -0.2], np.float32), 0.7
    out = jk.run(np.int32(5), j_res_gauss(jnp.asarray(loc), scale, 8, 8),
                 *jpool, _pad(th), _pad(y), jnp.asarray(lk)[None])
    kern = PoolISIRMixed(d, program=port, global_frequency=gf, batch_size=B,
                         steps_per_call=T)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    pool = (t(np.asarray(jpool[0])[:, :, :d]), t(np.asarray(jpool[1])[:, :, :Y]),
            t(np.asarray(jpool[2])[:, :B]), t(np.asarray(jpool[3])[:, :B]))
    got = kern.plain(0, resident_from_gaussian(loc, scale), *pool, t(th),
                     t(y), t(lk), draws=_stub_draws)
    _close(got[0].numpy(), np.asarray(out[0])[:d], "theta")
    _close(got[1].numpy(), np.asarray(out[1])[:Y], "y")
    _close(got[2].numpy(), np.asarray(out[2])[0], "logk")
    for a, b in zip(got[3:6], out[3:6]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[0])
    _close(got[6].numpy(), np.asarray(out[6])[:, :d], "history")
    if gf > 0:      # every coin global: the pool's candidates win
        assert float(got[3].min()) == T and float(got[4].sum()) > 0
    else:           # every coin local: the program's move is accepted
        assert float(got[3].max()) == 0 and float(got[5].sum()) > 0


# ------------------------------------------------ determinism and resume
def _ma2(eps=0.2):
    jp = glabc_tpu.MA2Problem(epsilon=eps, num_draws=16)
    return ma2_problem_from_numpy(np.asarray(jp.y_obs), eps, 16)


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("algorithm", ["glmcmc", "global"])
def test_fused_program_bitwise_across_launch_shapes(algorithm):
    prob = _ma2()
    run = lambda **kw: run_fused_program(
        prob, prob.tile_program(), gen(0), 21, np.zeros(2), num_chains=32,
        global_frequency=0.8, algorithm=algorithm, device="cpu",
        **{"steps_per_call": 10, **kw})
    a, b, c = run(), run(steps_per_call=20, block_chains=64), run(
        steps_per_call=6)
    assert a.thetas.shape == (32, 21, 2)
    for r in (b, c):
        np.testing.assert_array_equal(a.thetas, r.thetas)
    for x, y in zip(a.counts, b.counts):   # whole launches: exact counts
        np.testing.assert_array_equal(x, y)
    ch = a.thetas.reshape(-1, 2)
    assert np.all((ch[:, 1] < 1.0) & (ch[:, 1] > np.abs(ch[:, 0]) - 1.0))


def test_fused_program_resume_is_bitwise(tmp_path):
    prob = _ma2()
    kw = dict(num_chains=16, steps_per_call=4, device="cpu")
    full = run_fused_program(prob, prob.tile_program(), gen(3), 17,
                             np.zeros(2), **kw)
    ck = str(tmp_path / "ck")
    first = run_fused_program(prob, prob.tile_program(), gen(3), 9,
                              np.zeros(2), checkpoint_path=ck, **kw)
    rest = run_fused_program(prob, prob.tile_program(), gen(77), 17,
                             np.zeros(2), checkpoint_path=ck, resume=True,
                             **kw)
    np.testing.assert_array_equal(first.thetas, full.thetas[:, :9])
    np.testing.assert_array_equal(rest.thetas, full.thetas[:, 9:])
    for x, y in zip(rest.counts, full.counts):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("coin_mode", ["shared", "per_chain"])
def test_glmala_program_bitwise_and_resume(coin_mode, tmp_path, monkeypatch):
    prob = _ma2()
    kw = dict(num_chains=16, num_grad=4, tau=0.1, coin_mode=coin_mode,
              device="cpu")
    run = lambda n, **k: run_glmala_program(
        prob, prob.tile_program(), gen(1), n, np.zeros(2),
        **{**kw, "steps_per_call": 4, **k})
    a = run(13)
    monkeypatch.setattr(fused_program, "_GRAD_CHUNK", 5)  # 4 gradient chunks
    b = run(13, steps_per_call=12, block_chains=64)
    monkeypatch.undo()
    np.testing.assert_array_equal(a.thetas, b.thetas)
    for x, y in zip(a.counts, b.counts):
        np.testing.assert_array_equal(x, y)
    ck = str(tmp_path / "ck")
    first = run(9, checkpoint_path=ck)
    rest = run_glmala_program(prob, prob.tile_program(), gen(50), 13,
                              np.zeros(2), steps_per_call=4,
                              checkpoint_path=ck, resume=True, **kw)
    np.testing.assert_array_equal(first.thetas, a.thetas[:, :9])
    np.testing.assert_array_equal(rest.thetas, a.thetas[:, 9:])
    assert np.all(a.counts.global_attempts + a.counts.local_attempts == 12)


def test_aglmcmc_program_bitwise_and_resume(tmp_path):
    prob = _ma2()
    ip = DiagGaussian.create(2, 0.0, float(np.log(0.5)))
    kw = dict(global_frequency=0.5, step_size=4, num_chains=16,
              shared_support=32, tile_program=prob.tile_program(),
              device="cpu")
    run = lambda n, **k: run_aglmcmc_fused_mixed(
        prob, gen(2), n, np.zeros(2), ip, **{**kw, **k})
    a = run(25)
    b = run(25, block_chains=64)
    np.testing.assert_array_equal(a.thetas, b.thetas)
    assert a.thetas.shape == (16, 25, 2)
    c = a.counts
    assert np.all(c.global_attempts + c.local_attempts == 24)
    assert c.local_accepts.sum() > 0 and c.global_accepts.sum() > 0
    ck = str(tmp_path / "ck")
    first = run(17, checkpoint_path=ck)
    rest = run_aglmcmc_fused_mixed(prob, gen(9), 25, np.zeros(2), ip,
                                   checkpoint_path=ck, resume=True, **kw)
    np.testing.assert_array_equal(first.thetas, a.thetas[:, :17])
    np.testing.assert_array_equal(rest.thetas, a.thetas[:, 17:])
    assert a.final_carry.y.shape == (16, 3)


# ------------------------------------------------- statistics against JAX
# Limits of the comparison with JAX's scan path, from the spread over 5
# seeds of each side at these sizes (``python tests/test_torch_generic.py
# 5``): posterior mean and sd per dim after the burn-in, as absolute
# differences of one run each.  5 seeds read sds of the two means 0.023 /
# 0.021 (JAX GLMCMC), 0.018 / 0.030 (port), 0.013 / 0.029 (JAX GLMALA),
# 0.023 / 0.021 (port), and of the two posterior sds 0.015 / 0.010, 0.024 /
# 0.011, 0.017 / 0.009, 0.014 / 0.002: each limit is about 4 sd of the
# difference of one run each.
SLICE = dict(chains=64, iters=201, burn=50, num_grad=10, mean_atol=0.15,
             sd_atol=0.12)


def _moments(thetas):
    ch = np.asarray(thetas, np.float64)[:, SLICE["burn"]:].reshape(-1, 2)
    inside = np.all((ch[:, 1] < 1.0 + 1e-6)
                    & (ch[:, 1] > np.abs(ch[:, 0]) - 1.0 - 1e-6))
    return np.concatenate([ch.mean(0), ch.std(0)]), inside


def _slice_run(side, seed):
    jprob = glabc_tpu.MA2Problem(num_draws=16)
    prob = _ma2()
    n, Cs, g = SLICE["iters"], SLICE["chains"], SLICE["num_grad"]
    box = (np.array([-2.0, -1.0], np.float32), np.array([2.0, 1.0], np.float32))
    if side == "jax_glmcmc":
        from glabc_tpu.samplers import run_glmcmc
        r = run_glmcmc(jprob, jax.random.PRNGKey(seed), n, jnp.zeros(2),
                       glabc_tpu.Uniform(*map(jnp.asarray, box)),
                       glabc_tpu.DiagGaussian.create(2, 0.0,
                                                     float(np.log(0.1))),
                       0.8, 5, num_chains=Cs, segment_size=n)
    elif side == "jax_glmala":
        from glabc_tpu.samplers.glmala import run_glmala
        r = run_glmala(jprob, jax.random.PRNGKey(seed), n, jnp.zeros(2),
                       glabc_tpu.Uniform(*map(jnp.asarray, box)), 0.8, 5,
                       0.1, g, num_chains=Cs, segment_size=n)
    elif side == "glmcmc":
        r = run_fused_program(prob, prob.tile_program(), gen(seed), n,
                              np.zeros(2), global_frequency=0.8,
                              num_chains=Cs, steps_per_call=100,
                              device="cpu")
    else:
        r = run_glmala_program(prob, prob.tile_program(), gen(seed), n,
                               np.zeros(2), global_frequency=0.8, tau=0.1,
                               num_grad=g, num_chains=Cs, steps_per_call=50,
                               coin_mode="per_chain", device="cpu")
    return _moments(r.thetas)


@pytest.fixture(scope="module")
def slice_runs():
    return {side: _slice_run(side, seed) for side, seed in
            (("jax_glmcmc", 0), ("glmcmc", 1), ("jax_glmala", 2),
             ("glmala", 3))}


@pytest.mark.parametrize("side", ["glmcmc", "glmala"])
def test_program_slice_matches_jax_statistically(slice_runs, side):
    (got, inside), (ref, ref_inside) = slice_runs[side], \
        slice_runs["jax_" + side]
    assert inside and ref_inside
    assert np.all(np.abs(got[:2] - ref[:2]) <= SLICE["mean_atol"]), (got, ref)
    assert np.all(np.abs(got[2:] - ref[2:]) <= SLICE["sd_atol"]), (got, ref)


# ----------------------------------------------------------------- runner
def test_runner_tile_program_routes(tmp_path):
    prob = _ma2()
    prog = prob.tile_program()
    runner = MCMCRunner(prob, output_dir=str(tmp_path), num_chains=16,
                        verbose=False, device="cpu")
    ch = runner.run_glmala(9, np.zeros(2), None, 0.8, None, 5, 0.1, 4,
                           method="fused", tile_program=prog,
                           steps_per_call=4)
    assert ch.shape == (16, 9, 2)
    csv = np.loadtxt(tmp_path / "glmala_results.csv", delimiter=",")
    np.testing.assert_allclose(csv, ch[0], rtol=1e-6, atol=1e-7)
    ip = DiagGaussian.create(2, 0.0, float(np.log(0.5)))
    ch = runner.run_aglmcmc(13, np.zeros(2), None, 0.5, None, ip, 5, 4, 0.8,
                            0.2, output_file=None, method="fused",
                            tile_program=prog, shared_support=32)
    assert ch.shape == (16, 13, 2)
    assert runner.last_result.counts.local_attempts.sum() > 0
    # a JAX program (or anything but the port's) is refused
    jprog = glabc_tpu.MA2Problem(num_draws=16).tile_program()
    with pytest.raises(TypeError, match="TileProgram"):
        runner.run_glmala(5, np.zeros(2), None, 0.8, None, 5, 0.1, 4,
                          method="fused", tile_program=jprog)
    with pytest.raises(TypeError, match="TileProgram"):
        runner.run_aglmcmc(5, np.zeros(2), None, 0.5, None, ip, 5, 4, 0.8,
                           0.2, method="fused", tile_program=jprog)
    with pytest.raises(TypeError, match="TileProgram"):
        run_fused_program(prob, jprog, gen(0), 5, np.zeros(2), device="cpu")
    with pytest.raises(ValueError, match="method='fused'"):
        runner.run_glmala(5, np.zeros(2), None, 0.8, None, 5, 0.1, 4,
                          method="scan", tile_program=prog)
    with pytest.raises(ValueError, match="global_frequency"):
        runner.run_aglmcmc(5, np.zeros(2), None, 1.0, None, ip, 5, 4, 0.8,
                           0.2, method="fused", tile_program=prog)
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_glmala_program(prob, prog, gen(0), 5, np.zeros(2), mesh=object(),
                           device="cpu")
    if not torch.cuda.is_available():   # no silent fallback to the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_fused_program(prob, prog, gen(0), 5, np.zeros(2))
    box = Uniform(torch.tensor([-2.0, -1.0]), torch.tensor([2.0, 1.0]))
    ch = runner.run_glmcmc(9, np.zeros(2), None, 0.8,
                           DiagGaussian.create(2, 0.0, float(np.log(0.1))),
                           box, 5, output_file=None)
    assert np.isfinite(ch).all()


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_generic.py [n]
    #   the seed spread behind SLICE
    import sys

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    for side in ("jax_glmcmc", "glmcmc", "jax_glmala", "glmala"):
        rows = np.asarray([_slice_run(side, 100 + s)[0] for s in range(n)])
        print(side, "mean", rows.mean(0).round(5).tolist(), "sd",
              rows.std(0, ddof=1).round(5).tolist(), flush=True)
