"""GLMALA in glabc_tpu_torch held against glabc_tpu, on the CPU.

* ``synthetic_likelihood_grad`` (the plain estimator) on identical
  simulator noise against glabc_tpu's ``_sl_log_prob`` composed with its
  prior gradient: ``crn_fd`` (one noise array per coordinate, shared by both
  signs) and ``autodiff``, to 1e-5 relative.
* K6: the plain version against ``PackedMixtureGLMALA`` in interpret mode,
  where every PRNG bit is 0, fed the same constant uniforms (2^-25), both
  coin modes, to 1e-5 (the JAX kernel rewrites the Gaussian log-densities,
  so rounding differs; the gradient to 1e-4, see below); counters
  exactly.  Its local and global branches
  against the same transition composed from glabc_tpu's functions on random
  noise, with one noise vector per replicate serving both signs and every
  coordinate (the kernel's CRN design), to 1e-4 relative, the gradient to
  5e-3 (the kernel's one-pass variance against ``jnp.var``'s two passes).
* The slice as a whole: ``run_glmala`` and ``run_glmala_fused`` (the
  kernel's plain version) against glabc_tpu's ``run_glmala``,
  statistically, within limits set from the seed spread of each side
  (``SLICE``; ``PYTHONPATH=. JAX_PLATFORMS=cpu python
  tests/test_torch_glmala.py 5`` prints it).
* Bitwise determinism across ``segment_size``, ``steps_per_call``,
  ``block_chains`` and resume; the runner's routing and its errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glabc_tpu
from glabc_tpu.ops.pallas.glmala_kernel import PackedMixtureGLMALA
from glabc_tpu.samplers.glmala import _sl_log_prob, _std_normal_logpdf
from glabc_tpu.samplers.glmala import run_glmala as j_run_glmala
from glabc_tpu_torch import DiagGaussian, MCMCRunner, MixtureProblem
from glabc_tpu_torch.ops.kernels import FusedMixtureGLMALA
from glabc_tpu_torch.ops.kernels.glmala_kernel import (
    MalaNoise, kernel_sl_grad, mala_noise_from_uniforms, mala_transition)
from glabc_tpu_torch.samplers import (run_glmala, run_glmala_fused,
                                      synthetic_likelihood_grad)
from glabc_tpu_torch.utils.convert import glmala_state_from_packed

torch.set_num_threads(1)

PROB = MixtureProblem(0.05)
JPROB = glabc_tpu.MixtureProblem(0.05)
SIGMA = PROB._noise_std
IP = DiagGaussian.create(2, 0.0, 0.0)
JIP = glabc_tpu.DiagGaussian.create(2, 0.0, 0.0)
U0 = 2.0 ** -25          # interpret mode's every uniform


def gen(seed):
    return torch.Generator().manual_seed(seed)


class _Fixed(MixtureProblem):
    """The Mixture problem whose simulator adds the given noise."""

    def __init__(self, noise):
        super().__init__(0.05)
        self.noise = noise

    def simulate(self, theta, generator=None):
        return theta.abs() + self._noise_std * self.noise


class _JStub:
    """glabc_tpu's Mixture problem with the PRNG key replaced by the noise
    array itself, so that ``_sl_log_prob`` runs on given noise."""

    epsilon = 0.05

    def simulate(self, noise, theta):
        return jnp.abs(theta) + SIGMA * noise

    def discrepancy(self, y):
        return JPROB.discrepancy(y)


def _jax_sl_grad(theta, noise, fd, shared):
    """glabc_tpu's estimator on given noise: ``noise[c, k]`` (per
    coordinate, ``shared=False``) or ``noise[c]`` for every coordinate."""
    C, d = theta.shape
    out = np.zeros((C, d), np.float32)
    for c in range(C):
        th = jnp.asarray(theta[c])
        for k in range(d):
            z = noise[c] if shared else noise[c, k]
            e = jnp.zeros(d).at[k].set(fd)
            n = z.shape[0]
            lp = [_sl_log_prob(_JStub(), jnp.asarray(z),
                               jnp.broadcast_to(th + s * e, (n, d)))
                  for s in (1.0, -1.0)]
            out[c, k] = (lp[0] - lp[1]) / (2.0 * fd)
        out[c] += np.asarray(JPROB.prior_grad(th))
    return out


# ------------------------------------------------------- gradient estimator
def test_crn_fd_gradient_matches_jax_on_identical_noise():
    C, d, n = 6, 2, 40
    rng = np.random.default_rng(0)
    theta = rng.normal(0, 1.2, (C, d)).astype(np.float32)
    noise = rng.normal(size=(C, d, n, d)).astype(np.float32)
    got = synthetic_likelihood_grad(_Fixed(torch.from_numpy(noise)), gen(0),
                                    torch.from_numpy(theta), n, 0.1)
    want = _jax_sl_grad(theta, noise, 0.1, shared=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_autodiff_gradient_matches_jax_on_identical_noise():
    C, d, n = 6, 2, 40
    rng = np.random.default_rng(1)
    theta = rng.normal(0, 1.2, (C, d)).astype(np.float32)
    noise = rng.normal(size=(C, n, d)).astype(np.float32)
    got = synthetic_likelihood_grad(_Fixed(torch.from_numpy(noise)), gen(0),
                                    torch.from_numpy(theta), n,
                                    mode="autodiff")
    for c in range(C):
        g = jax.grad(lambda t: _sl_log_prob(
            _JStub(), jnp.asarray(noise[c]), jnp.broadcast_to(t, (n, d))))(
                jnp.asarray(theta[c]))
        want = np.asarray(g + JPROB.prior_grad(jnp.asarray(theta[c])))
        np.testing.assert_allclose(got[c].numpy(), want, rtol=1e-5,
                                   atol=1e-4)
    with pytest.raises(ValueError, match="grad_mode"):
        synthetic_likelihood_grad(PROB, gen(0), torch.zeros(2, 2), 4,
                                  mode="nope")


def test_crn_fd_uses_common_random_numbers():
    """The generator's draws are the same for both signs: with fd -> 0 the
    plus and minus discrepancies coincide, so the estimate is the prior
    gradient exactly at a point where |theta| is smooth."""
    theta = torch.tensor([[0.7, -1.1], [1.3, 0.4]])
    g = synthetic_likelihood_grad(PROB, gen(3), theta, 50, fd_step=1e-30)
    np.testing.assert_allclose(g.numpy(), (-theta).numpy(), atol=1e-6)
    a = synthetic_likelihood_grad(PROB, gen(4), theta, 50)
    b = synthetic_likelihood_grad(PROB, gen(4), theta, 50)
    assert torch.equal(a, b)


# ------------------------------------------------------------------- K6
def _packed(x_cd, pack, C_cols):
    """(pack*C, d) chains -> the JAX packed (8, C) layout."""
    d = x_cd.shape[1]
    return x_cd.reshape(pack, C_cols, d).transpose(0, 2, 1).reshape(
        pack * d, C_cols)


@pytest.mark.parametrize("coin_mode,coins", [("shared", [0, 1]),
                                             ("shared", [1, 0]),
                                             ("per_chain", [0, 0])])
def test_k6_plain_matches_pallas_interpret(coin_mode, coins):
    d, C_cols, T, n_g = 2, 128, 2, 4
    pack = 8 // d
    C = pack * C_cols
    rng = np.random.default_rng(len(coin_mode) + sum(coins))
    # states whose drift lands near y_obs: the local move accepts for some
    theta = rng.normal(-0.27, 0.3, (C, d)).astype(np.float32)
    y = (np.abs(theta) + 1.0 + rng.uniform(0, 2, (C, d))).astype(np.float32)
    logk = np.asarray(JPROB.kernel_log_prob(JPROB.discrepancy(
        jnp.asarray(y))))
    grad = rng.normal(size=(C, d)).astype(np.float32)
    jk = PackedMixtureGLMALA(
        d, JPROB.y_obs, epsilon=0.05, sigma=SIGMA, global_frequency=0.8,
        batch_size=5, tau=0.3, num_grad=n_g, fd_step=0.1, steps_per_call=T,
        block_chains=128, coin_mode=coin_mode, interpret=True)
    out = jk.run(np.int32(1), np.asarray(coins, np.int32),
                 *(jnp.asarray(_packed(a, pack, C_cols)) for a in
                   (theta, y, np.repeat(logk[:, None], d, 1), grad)))
    kern = FusedMixtureGLMALA(d, np.asarray(PROB.y_obs), epsilon=0.05,
                              sigma=SIGMA, global_frequency=0.8,
                              num_grad=n_g, steps_per_call=T,
                              coin_mode=coin_mode)
    cfg = kern.cfg
    noise = mala_noise_from_uniforms(
        torch.full((C, 8), U0), torch.full((C, 6, d, 2), U0),
        torch.full((C, cfg.grad_pairs, d, 2), U0), cfg)
    t = lambda a: torch.from_numpy(np.array(a, np.float32, order="C"))
    got = kern.plain(0, t(theta.T), t(y.T), t(logk), t(grad.T),
                     torch.tensor(coins, dtype=torch.int32),
                     noise=lambda s: noise)
    conv = lambda a: glmala_state_from_packed(a, d).numpy()
    for name, a, b in zip(("theta", "y"), got[:2], out[:2]):
        np.testing.assert_allclose(a.numpy(), conv(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    # the gradient divides a difference of log-densities near 10 by 2 fd
    np.testing.assert_allclose(got[3].numpy(), conv(out[3]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(),
                               glmala_state_from_packed(out[2], d, aux=True)
                               .numpy(), rtol=1e-5, atol=1e-4)
    for s in range(T):
        np.testing.assert_allclose(got[4][s].numpy(), conv(out[4][s]),
                                   rtol=1e-5, atol=1e-5)
    for a, b in zip(got[5], out[5]):
        np.testing.assert_array_equal(
            a.numpy(), glmala_state_from_packed(b, d, aux=True).numpy())
    lacc = float(got[5][3].sum())
    if coin_mode == "shared":
        assert 0 < lacc < C * (T - sum(coins))   # accepts and rejects
        assert not np.allclose(got[3].numpy(), grad.T)
    else:
        # interpret mode's coin uniform 2^-25 < gf: every step global
        assert float(got[5][1].min()) == T and lacc == 0


def _noise(rng, C, B, d, n):
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    u = lambda *s: torch.from_numpy(rng.uniform(size=s).astype(np.float32))
    return MalaNoise(-torch.log(-torch.log(u(C, B + 1))), u(C), u(C),
                     f(C, B, d), f(C, B, d), f(C, d), f(C, d), f(C, n, d))


def _composed_local(theta, y, logk, grad, nz, tau=0.3, fd=0.1):
    """The MALA move from glabc_tpu's functions on the given noise, the
    gradient by the kernel's CRN design."""
    th = jnp.asarray(theta)
    z = jnp.asarray(nz.z.numpy())
    th_p = z * tau + th + jnp.asarray(grad) * tau ** 2 / 2.0
    g_p = _jax_sl_grad(np.asarray(th_p), nz.zg.numpy(), fd, shared=True)
    y_p = jnp.abs(th_p) + SIGMA * jnp.asarray(nz.z_sim.numpy())
    lk_p = JPROB.kernel_log_prob(JPROB.discrepancy(y_p))
    log_rev = _std_normal_logpdf((th - th_p - g_p * tau ** 2 / 2.0) / tau)
    log_acc = (JPROB.prior_log_prob(th_p) + lk_p + log_rev
               - JPROB.prior_log_prob(th) - jnp.asarray(logk)
               - _std_normal_logpdf(z))
    acc = np.asarray(jnp.log(jnp.asarray(nz.u_accept.numpy())) < log_acc)
    sel = lambda a, b: np.where(acc.reshape(-1, *([1] * (np.ndim(a) - 1))),
                                np.asarray(a), np.asarray(b))
    return (sel(th_p, theta), sel(y_p, y), sel(lk_p, logk), sel(g_p, grad),
            acc)


def test_k6_local_branch_matches_composed_jax_step():
    C, B, d, n = 64, 5, 2, 12
    rng = np.random.default_rng(5)
    theta = rng.normal(0, 1.4, (C, d)).astype(np.float32)
    y = (np.abs(theta) + 0.2 * rng.normal(size=(C, d))).astype(np.float32)
    logk = np.array(JPROB.kernel_log_prob(JPROB.discrepancy(
        jnp.asarray(y))))
    grad = rng.normal(size=(C, d)).astype(np.float32)
    nz = _noise(rng, C, B, d, n)
    kern = FusedMixtureGLMALA(d, np.asarray(PROB.y_obs), epsilon=0.05,
                              sigma=SIGMA, num_grad=n)
    t = torch.from_numpy
    (th2, y2, lk2, g2), inc = mala_transition(
        (t(theta), t(y), t(logk), t(grad)), nz, kern.cfg, coin=False)
    want = _composed_local(theta, y, logk, grad, nz)
    tol = dict(rtol=1e-4, atol=1e-4)
    for a, b in zip((th2, y2, lk2), want[:3]):
        np.testing.assert_allclose(a.numpy(), b, **tol)
    # the kernel's variance is one pass, (s2 - n mu^2) / (n - 1), JAX's
    # two (jnp.var): at a small spread the one-pass form loses digits, and
    # the gradient divides a difference of log-densities by 2 fd
    gtol = dict(rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(g2.numpy(), want[3], **gtol)
    np.testing.assert_array_equal(inc[3].numpy() > 0, want[4])
    assert 0 < want[4].sum() < C
    # the kernel's gradient alone, at the current states
    g = kernel_sl_grad(t(theta), nz.zg, kern.cfg)
    np.testing.assert_allclose(
        g.numpy(), _jax_sl_grad(theta, nz.zg.numpy(), 0.1, shared=True),
        **gtol)
    # per-chain coins select between this and the global branch
    (th3, _, _, g3), inc3 = mala_transition(
        (t(theta), t(y), t(logk), t(grad)), nz, kern.cfg)
    is_g = nz.u_coin.numpy() < np.float32(0.8)
    np.testing.assert_array_equal(inc3[1].numpy() > 0, is_g)
    np.testing.assert_array_equal(th3.numpy()[~is_g], th2.numpy()[~is_g])
    np.testing.assert_array_equal(g3.numpy()[is_g], grad[is_g])


def test_k6_wrapper_checks():
    with pytest.raises(ValueError, match=r"\{1, 2, 4, 8\}"):
        FusedMixtureGLMALA(3, [1.5] * 3, epsilon=0.5, sigma=0.2)
    with pytest.raises(ValueError, match="coin_mode"):
        FusedMixtureGLMALA(2, [1.5, 1.5], epsilon=0.05, sigma=0.2,
                           coin_mode="both")
    kern = FusedMixtureGLMALA(2, [1.5, 1.5], epsilon=0.05, sigma=0.2,
                              steps_per_call=3, num_grad=4)
    st = [torch.zeros(2, 32), torch.ones(2, 32), torch.zeros(32),
          torch.zeros(2, 32)]
    coins = torch.tensor([1, 0, 1], dtype=torch.int32)
    out = kern.run(0, *st, coins)
    assert out[4].shape == (3, 2, 32) and FusedMixtureGLMALA.launches == 0
    assert float(out[5][1].mean()) == 2.0
    with pytest.raises(ValueError, match="coins"):
        kern.run(0, *st)
    with pytest.raises(ValueError, match="grad"):
        kern.run(0, *st[:3], torch.zeros(2, 31), coins)
    with pytest.raises(ValueError, match="no kernel"):
        kern.run(0, *(x.to("meta") for x in st), coins)
    with pytest.raises(ValueError, match="theta_dim"):
        run_glmala_fused(glabc_like_d3(), gen(0), 5, np.zeros(3),
                         num_chains=8, device="cpu")


def glabc_like_d3():
    from glabc_tpu_torch import HighDimMixtureProblem
    return HighDimMixtureProblem(3)


# --------------------------------------------------- drivers and the slice
def _fused(seed=0, **kw):
    args = dict(num_grad=8, num_chains=16, steps_per_call=8, device="cpu")
    args.update(kw)
    return run_glmala_fused(PROB, gen(seed), 41, np.zeros(2), **args)


@pytest.mark.parametrize("coin_mode", ["shared", "per_chain"])
def test_fused_bitwise_across_launch_shapes(coin_mode):
    a = _fused(coin_mode=coin_mode)
    b = _fused(coin_mode=coin_mode, steps_per_call=16, block_chains=64)
    c = _fused(coin_mode=coin_mode, steps_per_call=40)
    assert a.thetas.shape == (16, 41, 2)
    for r in (b, c):
        np.testing.assert_array_equal(a.thetas, r.thetas)
    # b's last launch is ragged (counts pro rata); c's is whole
    for x, y in zip(a.counts, c.counts):
        np.testing.assert_array_equal(x, y)
    c = a.counts
    assert np.all(c.global_attempts + c.local_attempts == 40)
    if coin_mode == "shared":   # one coin per step for every chain
        assert len(set(c.global_attempts.tolist())) == 1


def test_fused_resume_is_bitwise(tmp_path):
    ck = str(tmp_path / "ck")
    full = _fused(seed=2, steps_per_call=8)
    part = _fused(seed=2, steps_per_call=8, checkpoint_path=ck)
    np.testing.assert_array_equal(full.thetas, part.thetas)
    # cut the run after 3 launches, then resume
    first = run_glmala_fused(PROB, gen(2), 25, np.zeros(2), num_grad=8,
                             num_chains=16, steps_per_call=8,
                             checkpoint_path=str(tmp_path / "c2"),
                             device="cpu")
    rest = run_glmala_fused(PROB, gen(99), 41, np.zeros(2), num_grad=8,
                            num_chains=16, steps_per_call=8,
                            checkpoint_path=str(tmp_path / "c2"),
                            resume=True, device="cpu")
    np.testing.assert_array_equal(first.thetas, full.thetas[:, :25])
    np.testing.assert_array_equal(rest.thetas, full.thetas[:, 25:])
    for x, y in zip(rest.counts, full.counts):
        np.testing.assert_array_equal(x, y)


def test_scan_bitwise_across_segments_and_resume(tmp_path):
    kw = dict(num_chains=8, device="cpu")
    a = run_glmala(PROB, gen(1), 31, np.zeros(2), IP, 0.8, 5, 0.3, 8,
                   segment_size=30, **kw)
    b = run_glmala(PROB, gen(1), 31, np.zeros(2), IP, 0.8, 5, 0.3, 8,
                   segment_size=7, **kw)
    np.testing.assert_array_equal(a.thetas, b.thetas)
    ck = str(tmp_path / "s")
    run_glmala(PROB, gen(1), 15, np.zeros(2), IP, 0.8, 5, 0.3, 8,
               segment_size=7, checkpoint_path=ck, **kw)
    rest = run_glmala(PROB, gen(5), 31, np.zeros(2), IP, 0.8, 5, 0.3, 8,
                      segment_size=7, checkpoint_path=ck, resume=True, **kw)
    np.testing.assert_array_equal(rest.thetas, a.thetas[:, 15:])
    for mode in ("autodiff",):
        r = run_glmala(PROB, gen(1), 11, np.zeros(2), IP, 0.8, 5, 0.3, 8,
                       grad_mode=mode, refresh_grad_after_global=True, **kw)
        assert np.isfinite(r.thetas).all()


def test_runner_routes_glmala(tmp_path):
    runner = MCMCRunner(PROB, output_dir=str(tmp_path), num_chains=16,
                        verbose=False, device="cpu")
    ch = runner.run_glmala(17, np.zeros(2), None, 0.8, IP, 5, 0.3, 8,
                           method="fused", steps_per_call=8)
    assert ch.shape == (16, 17, 2)
    csv = np.loadtxt(tmp_path / "glmala_results.csv", delimiter=",")
    np.testing.assert_allclose(csv, ch[0], rtol=1e-6, atol=1e-7)
    ch = runner.run_glmala(9, np.zeros(2), None, 0.8, IP, 5, 0.3, 8,
                           output_file=None, coin_mode="per_chain",
                           method="fused")
    assert ch.shape == (16, 9, 2)
    ch = runner.run_glmala(9, np.zeros(2), None, 0.8, IP, 5, 0.3, 8,
                           output_file=None)
    assert ch.shape == (16, 9, 2)
    with pytest.raises(ValueError, match="method"):
        runner.run_glmala(9, np.zeros(2), None, 0.8, IP, 5, 0.3, 8,
                          method="pooled")
    with pytest.raises(ValueError, match="isotropic"):
        runner.run_glmala(9, np.zeros(2), None, 0.8,
                          DiagGaussian.create(2, [0.0, 1.0], 0.0), 5, 0.3, 8,
                          method="fused")
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_glmala_fused(PROB, gen(0), 5, np.zeros(2), mesh=object(),
                         device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_glmala(PROB, gen(0), 5, np.zeros(2), IP, mesh=object(),
                   device="cpu")
    if not torch.cuda.is_available():   # no silent fallback to the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_glmala_fused(PROB, gen(0), 5, np.zeros(2), num_chains=8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_glmala(PROB, gen(0), 5, np.zeros(2), IP)


# Limits of the whole-slice comparison, from the spread over 5 seeds of each
# side at these sizes (``python tests/test_torch_glmala.py 5``): the port's
# E|theta| and global/local acceptance against JAX's, as absolute
# differences of one run each (fused: per-chain coins, the JAX scan's).
# 5 seeds read sds of E|theta| 0.0073 (JAX) / 0.0118 (scan) / 0.0080
# (fused), of the global rate 0.00027 / 0.00074 / 0.00066, of the local
# rate 0.00154 / 0.00172 / 0.00114: each limit is about 4 sd of the
# difference of one run each.
SLICE = dict(chains=128, iters=401, num_grad=20, burn=100, abs_atol=0.05,
             gacc_atol=0.003, lacc_atol=0.009)


def _slice_stats(thetas, counts):
    c = counts
    ch = np.asarray(thetas)[:, SLICE["burn"]:]
    absmean = float(np.abs(ch).mean(dtype=np.float64))
    g = float(np.sum(c.global_accepts) / np.sum(c.global_attempts))
    l_ = float(np.sum(c.local_accepts) / np.sum(c.local_attempts))
    return absmean, g, l_


def _slice_run(side, seed):
    C, n, g = SLICE["chains"], SLICE["iters"], SLICE["num_grad"]
    if side == "jax":
        r = j_run_glmala(JPROB, jax.random.PRNGKey(seed), n, jnp.zeros(2),
                         JIP, 0.8, 5, 0.3, g, num_chains=C, segment_size=n)
        return _slice_stats(r.thetas, jax.tree_util.tree_map(np.asarray,
                                                             r.counts))
    if side == "scan":
        r = run_glmala(PROB, gen(seed), n, np.zeros(2), IP, 0.8, 5, 0.3, g,
                       num_chains=C, segment_size=n, device="cpu")
    else:
        r = run_glmala_fused(PROB, gen(seed), n, np.zeros(2), num_grad=g,
                             num_chains=C, coin_mode="per_chain",
                             device="cpu")
    return _slice_stats(r.thetas, r.counts)


@pytest.fixture(scope="module")
def slice_runs():
    return {side: _slice_run(side, seed) for side, seed in
            (("jax", 0), ("scan", 1), ("fused", 2))}


@pytest.mark.parametrize("side", ["scan", "fused"])
def test_slice_matches_jax_statistically(slice_runs, side):
    got, ref = slice_runs[side], slice_runs["jax"]
    assert abs(got[0] - ref[0]) <= SLICE["abs_atol"], (got, ref)
    assert abs(got[1] - ref[1]) <= SLICE["gacc_atol"], (got, ref)
    assert abs(got[2] - ref[2]) <= SLICE["lacc_atol"], (got, ref)


def _coin_split(n):
    """The shared coin's pooled local acceptance against the first coin of
    the run: ``n`` kernel seeds whose first shared coin is global and ``n``
    whose first is local, and ``n`` per-chain-coin runs (256 chains x
    2,049, num_grad=20, the kernel's plain version)."""
    def local_rate(mode, seed):
        r = run_glmala_fused(PROB, gen(seed), 2049, np.zeros(2), num_grad=20,
                             num_chains=256, coin_mode=mode, seed=seed,
                             collect_history=False, device="cpu")
        return float(r.counts.local_accepts.sum()
                     / r.counts.local_attempts.sum())

    seeds = range(2000, 3000)
    first_local = lambda s: np.random.default_rng(s).random(1)[0] >= 0.8
    for name, pick in (("first coin global", lambda s: not first_local(s)),
                       ("first coin local", first_local)):
        rates = [local_rate("shared", s) for s in
                 [s for s in seeds if pick(s)][:n]]
        print("shared,", name, np.round(rates, 5).tolist(), "mean",
              round(float(np.mean(rates)), 5))
    rates = [local_rate("per_chain", s) for s in seeds[:n]]
    print("per_chain", np.round(rates, 5).tolist(), "mean",
          round(float(np.mean(rates)), 5))


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_glmala.py [n]
    #   the seed spread behind SLICE;
    # ... tests/test_torch_glmala.py coin [n]: the shared coin's local rate
    #   against the run's first coin (PERF.md, Findings PR 4)
    import sys

    if sys.argv[1:2] == ["coin"]:
        _coin_split(int(sys.argv[2]) if len(sys.argv) > 2 else 8)
        sys.exit(0)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    for side in ("jax", "scan", "fused"):
        rows = np.asarray([_slice_run(side, 100 + s) for s in range(n)])
        print(side, "mean", rows.mean(0).round(5).tolist(), "sd",
              rows.std(0, ddof=1).round(5).tolist())
