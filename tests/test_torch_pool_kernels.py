"""The AGLMCMC kernels' plain versions held against glabc_tpu's Pallas
kernels (interpret mode on the CPU) and composed JAX functions.

* K3 (``PoolISIR``): in interpret mode every PRNG bit is 0, so every Gumbel
  is the same constant; the port's plain version gets that constant and the
  same pools (-inf log-weights included) and must agree exactly on theta,
  log-weight, ``sel``, move count and history.
* K4 (``batched_kde_log_prob``): the plain version against the Pallas
  kernel at d in {2, 3, 8} and 256 chains, to 2e-5 max(1, |log q|) (the
  logsumexp sums in another order), and against ``KernelDensity.log_prob``
  (another formula) to 2e-4.
* K5 (``PoolISIRMixed``): the plain version against the Pallas kernel in
  interpret mode (every coin global, constant Gumbels) to 1e-6, pool
  log-weights on a 0.1 grid so that no selection sits within rounding of a
  tie; ``resident_from_kde``/``resident_from_gaussian`` against the JAX
  densities to 1e-5; one transition on random noise (both branches, both
  outcomes) against the same step composed from glabc_tpu's functions, to
  rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glabc_tpu
from glabc_tpu.models.kde import KernelDensity as JKDE
from glabc_tpu.ops.pallas.kde_logprob_kernel import \
    batched_kde_log_prob as j_batched_kde_log_prob
from glabc_tpu.ops.pallas.pool_isir_kernel import PoolISIR as JPoolISIR
from glabc_tpu.ops.pallas.pool_isir_kernel import (pack_pool_logw as j_pack_logw,
                                                   pack_pool_theta as j_pack_theta)
from glabc_tpu.ops.pallas.pool_isir_mixed_kernel import PoolISIRMixed as JMixed
from glabc_tpu.ops.pallas.pool_isir_mixed_kernel import (
    resident_from_gaussian as j_res_gauss, resident_from_kde as j_res_kde)
from glabc_tpu.ops.resampling import sanitize_log_weights
from glabc_tpu_torch.ops.kernels import (BatchedMixtureLogProb, PoolISIR,
                                         PoolISIRMixed, batched_kde_log_prob,
                                         pack_pool_logw, pack_pool_theta,
                                         resident_from_gaussian,
                                         resident_from_kde)
from glabc_tpu_torch.ops.kernels.pool_isir_mixed_kernel import (
    MixedNoise, mixed_noise_from_uniforms, mixed_transition, resident_log_q)
from glabc_tpu_torch.utils.convert import (agl_state_from_numpy,
                                           kde_from_numpy, pool_slice_from_numpy,
                                           resident_from_numpy)

torch.set_num_threads(1)

U0 = 2.0 ** -25          # interpret mode's every uniform
PROB = glabc_tpu.MixtureProblem(0.05)


def _pools(rng, C, T, B, d, grid=False):
    theta = rng.normal(size=(C, T * B, d)).astype(np.float32)
    logw = rng.normal(-3.0, 2.0, (C, T * B)).astype(np.float32)
    if grid:
        logw = np.round(logw, 1).astype(np.float32)
    logw[rng.uniform(size=logw.shape) < 0.2] = -np.inf
    return theta, logw


# ----------------------------------------------------------------- K3
def test_pool_packing_matches_jax():
    rng = np.random.default_rng(0)
    theta, logw = _pools(rng, 16, 4, 3, 2)
    jt = j_pack_theta(jnp.asarray(theta), 4, 3, 8)
    jw = j_pack_logw(jnp.asarray(logw), 4, 3)
    pt, pw = pool_slice_from_numpy(jt, jw, 2, 3)
    assert torch.equal(pack_pool_theta(torch.from_numpy(theta), 4, 3), pt)
    assert torch.equal(pack_pool_logw(torch.from_numpy(logw), 4, 3), pw)
    with pytest.raises(ValueError):
        pack_pool_theta(torch.from_numpy(theta), 5, 3)


@pytest.mark.parametrize("d,B", [(2, 5), (3, 3), (2, 7)])
def test_pool_isir_matches_pallas_interpret(d, B):
    T, C = 6, 128
    rng = np.random.default_rng(10 * d + B)
    theta_p, logw_p = _pools(rng, C, T, B, d)
    theta0 = rng.normal(size=(C, d)).astype(np.float32)
    logw0 = rng.normal(-3.0, 2.0, (1, C)).astype(np.float32)
    logw0[0, :8] = -np.inf           # chains whose current state has no mass
    jk = JPoolISIR(d, batch_size=B, steps_per_call=T, block_chains=128,
                   interpret=True)
    jt = j_pack_theta(jnp.asarray(theta_p), T, B, jk.d_pad)
    jw = j_pack_logw(jnp.asarray(logw_p), T, B)
    th_k = jnp.zeros((jk.d_pad, C), jnp.float32).at[:d].set(theta0.T)
    out = jk.run(np.int32(3), jt, jw, th_k, jnp.asarray(logw0))

    pt, pw = pool_slice_from_numpy(jt, jw, d, B)
    kern = PoolISIR(d, batch_size=B, steps_per_call=T)
    g = torch.full((C, B + 1), float(-np.log(-np.log(np.float32(U0)))))
    got = kern.plain(0, pt, pw, agl_state_from_numpy(th_k, d),
                     agl_state_from_numpy(logw0, d), gumbels=lambda t: g)
    names = ("theta", "logw", "sel", "moved")
    for name, a, b in zip(names, got[:4], out[:4]):
        np.testing.assert_array_equal(a.numpy(),
                                      agl_state_from_numpy(b, d).numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(),
                                  np.asarray(out[4])[:, :d, :])
    assert 0 < float(got[3].mean()) < T and (got[2] == -1).any()


def test_pool_isir_wrapper_checks():
    kern = PoolISIR(2, batch_size=5, steps_per_call=4)
    pt, pw = torch.zeros(4, 5, 2, 32), torch.zeros(4, 5, 32)
    th, lw = torch.zeros(2, 32), torch.zeros(32)
    out = kern.run(0, pt, pw, th, lw)
    assert out[4].shape == (4, 2, 32) and PoolISIR.launches == 0
    with pytest.raises(ValueError, match="pool_logw"):
        kern.run(0, pt, torch.zeros(4, 8, 32), th, lw)
    with pytest.raises(TypeError):
        kern.run(0, pt.double(), pw, th, lw)
    with pytest.raises(ValueError, match="contiguous"):
        kern.run(0, pt, pw, torch.zeros(32, 2).T, lw)
    with pytest.raises(ValueError, match="no kernel"):
        kern.run(0, *(x.to("meta") for x in (pt, pw, th, lw)))
    with pytest.raises(ValueError):
        PoolISIR(2, batch_size=8)
    with pytest.raises(ValueError):
        PoolISIR(2, block_chains=100)
    off = PoolISIR(2, batch_size=5, steps_per_call=4, collect_history=False)
    assert off.run(0, pt, pw, th, lw)[4] is None


# ----------------------------------------------------------------- K4
@pytest.mark.parametrize("d", [2, 3, 8])
def test_kde_logprob_plain_matches_pallas_interpret(d):
    C, P, N = 256, 24, 20
    rng = np.random.default_rng(d)
    X = rng.normal(size=(C, P, d)).astype(np.float32)
    w = rng.uniform(size=(C, P)).astype(np.float32)
    w[:, ::5] = 0.0
    jk = jax.vmap(JKDE.fit)(jnp.asarray(X), jnp.asarray(w))
    x = rng.normal(0, 1.5, (C, N, d)).astype(np.float32)
    want = np.asarray(j_batched_kde_log_prob(jk, jnp.asarray(x),
                                             interpret=True))
    kdes = kde_from_numpy(jk.X, jk.weights, jk.bandwidth)
    got = batched_kde_log_prob(kdes, torch.from_numpy(x)).numpy()
    assert got.shape == (C, N)
    scale = np.maximum(1.0, np.abs(want))
    assert np.max(np.abs(got - want) / scale) <= 2e-5
    lp = np.asarray(jax.vmap(lambda k, p: k.log_prob(p))(jk, jnp.asarray(x)))
    assert np.max(np.abs(got - lp) / np.maximum(1.0, np.abs(lp))) <= 2e-4


def test_kde_logprob_wrapper_checks(monkeypatch):
    from glabc_tpu_torch.ops.kernels import kde_logprob_kernel

    monkeypatch.setattr(kde_logprob_kernel, "_PLAIN_CHUNK", 64)  # 5 chunks
    kern = BatchedMixtureLogProb()
    x, ms = torch.randn(5, 3, 2), torch.randn(5, 4, 2)
    pre, iv = torch.randn(5, 4), torch.rand(5, 2) + 0.5
    out = kern.run(x, ms, pre, iv)
    ref = BatchedMixtureLogProb().plain(x, ms, pre, iv)
    assert torch.equal(out, ref) and BatchedMixtureLogProb.launches == 0
    with pytest.raises(ValueError, match="pre"):
        kern.run(x, ms, torch.randn(5, 3), iv)
    with pytest.raises(ValueError):
        kern.run(x[0], ms, pre, iv)
    with pytest.raises(TypeError):
        kern.run(x, ms.double(), pre, iv)


# ----------------------------------------------------------------- K5
def _mixed_kernels(d, B, T, n_support, C):
    jk = JMixed(d, PROB.y_obs, epsilon=PROB.epsilon, sigma=PROB._noise_std,
                global_frequency=0.5, batch_size=B, steps_per_call=T,
                block_chains=C, n_support=n_support,
                support_chunk=n_support, collect_history=True,
                interpret=True)
    kern = PoolISIRMixed(d, np.asarray(PROB.y_obs), epsilon=PROB.epsilon,
                         sigma=PROB._noise_std, global_frequency=0.5,
                         batch_size=B, steps_per_call=T)
    return jk, kern


def test_resident_proposals_match_jax_densities():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(37, 2)).astype(np.float32)
    w = rng.uniform(size=37).astype(np.float32)
    w[5] = 0.0
    jk = JKDE.fit(jnp.asarray(X), jnp.asarray(w))
    pts = rng.normal(size=(50, 2)).astype(np.float32)
    res = resident_from_kde(kde_from_numpy(jk.X, jk.weights, jk.bandwidth))
    np.testing.assert_allclose(
        resident_log_q(res, torch.from_numpy(pts)).numpy(),
        np.asarray(jk.log_prob(jnp.asarray(pts))), rtol=1e-5, atol=1e-5)
    # the JAX resident, unpadded, is the port's
    jres = j_res_kde(jk, 8, 64)
    conv = resident_from_numpy(jres.mu_scaled, jres.pre, jres.inv2h, 2)
    for a, b in zip(conv, res):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    dg = glabc_tpu.DiagGaussian.create(2, 0.7, float(np.log(1.3)))
    rg = resident_from_gaussian([0.7, 0.7], 1.3)
    np.testing.assert_allclose(
        resident_log_q(rg, torch.from_numpy(pts)).numpy(),
        np.asarray(dg.log_prob(jnp.asarray(pts))), rtol=1e-5, atol=1e-5)
    jg = j_res_gauss(dg.loc, jnp.exp(dg.log_scale), 8, 8)
    for a, b in zip(resident_from_numpy(jg.mu_scaled, jg.pre, jg.inv2h, 2),
                    rg):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_pool_isir_mixed_matches_pallas_interpret():
    d, B, T, C = 2, 3, 6, 128
    rng = np.random.default_rng(7)
    jkde = JKDE.fit(jnp.asarray(rng.normal(size=(24, d)), jnp.float32))
    theta_p, logw_p = _pools(rng, C, T, B, d, grid=True)
    x_p = rng.normal(size=(C, T * B, d)).astype(np.float32)
    logk_p = rng.normal(size=(C, T * B)).astype(np.float32)
    theta0 = rng.normal(size=(C, d)).astype(np.float32)
    y0 = rng.normal(size=(C, d)).astype(np.float32)
    logk0 = rng.normal(size=(1, C)).astype(np.float32)
    jk, kern = _mixed_kernels(d, B, T, 32, C)
    jp = (j_pack_theta(jnp.asarray(theta_p), T, B, 8),
          j_pack_theta(jnp.asarray(x_p), T, B, 8),
          j_pack_logw(jnp.asarray(logw_p), T, B),
          j_pack_logw(jnp.asarray(logk_p), T, B))
    pad = lambda a: jnp.zeros((8, C), jnp.float32).at[:d].set(a.T)
    out = jk.run(np.int32(5), j_res_kde(jkde, 8, 32), *jp, pad(theta0),
                 pad(y0), jnp.asarray(logk0))

    res = resident_from_kde(kde_from_numpy(jkde.X, jkde.weights,
                                           jkde.bandwidth))
    pt, pw = pool_slice_from_numpy(jp[0], jp[2], d, B)
    px, pk = pool_slice_from_numpy(jp[1], jp[3], d, B)
    nz = mixed_noise_from_uniforms(torch.full((C, B + 3), U0),
                                   torch.full((C, d, 2), U0), B)
    got = kern.plain(0, res, pt, px, pw, pk,
                     *(agl_state_from_numpy(a, d) for a in
                       (pad(theta0), pad(y0), logk0)),
                     noise=lambda t: nz)
    names = ("theta", "y", "logk", "gatt", "gacc", "lacc")
    for name, a, b in zip(names, got[:6], out[:6]):
        np.testing.assert_allclose(a.numpy(),
                                   agl_state_from_numpy(b, d).numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(out[6])[:, :d],
                               rtol=1e-6, atol=1e-6)
    assert float(got[3].min()) == T and float(got[5].max()) == 0.0
    assert 0 < float(got[4].mean()) < T


def _composed_jax_step(state, sl, jkde, nz, gf):
    """One mixed transition from glabc_tpu's functions on explicit noise."""
    theta, y, logk = (jnp.asarray(a) for a in state)
    ptheta, px, plogw, plogk = (jnp.asarray(a) for a in sl)
    sigma = PROB._noise_std
    lp_theta = PROB.prior_log_prob(theta)
    log_w = jnp.concatenate(
        [(lp_theta + logk - jkde.log_prob(theta))[:, None], plogw], axis=1)
    idx = jnp.argmax(sanitize_log_weights(log_w) + jnp.asarray(nz["g"]),
                     axis=1)
    moved = idx > 0
    pick = jnp.maximum(idx - 1, 0)
    rows = jnp.arange(theta.shape[0])
    g_th = jnp.where(moved[:, None], ptheta[rows, pick], theta)
    g_y = jnp.where(moved[:, None], px[rows, pick], y)
    g_lk = jnp.where(moved, plogk[rows, pick], logk)
    thl = theta + 0.35 * jnp.asarray(nz["l1"])
    yl = jnp.abs(thl) + sigma * jnp.asarray(nz["l2"])
    lkl = PROB.kernel_log_prob(PROB.discrepancy(yl))
    l_acc = jnp.log(jnp.asarray(nz["u_local"])) < (
        PROB.prior_log_prob(thl) + lkl - lp_theta - logk)
    is_g = jnp.asarray(nz["u_coin"]) < gf
    out = (jnp.where(is_g[:, None], g_th, jnp.where(l_acc[:, None], thl, theta)),
           jnp.where(is_g[:, None], g_y, jnp.where(l_acc[:, None], yl, y)),
           jnp.where(is_g, g_lk, jnp.where(l_acc, lkl, logk)))
    inc = (is_g, is_g & moved, ~is_g & l_acc)
    return ([np.asarray(a) for a in out],
            [np.asarray(a, np.float32) for a in inc])


@pytest.mark.parametrize("gf", [0.0, 0.5, 1.0])
def test_mixed_transition_matches_composed_jax_step(gf):
    d, B, N = 2, 5, 256
    rng = np.random.default_rng(int(10 * gf))
    f32 = lambda a: np.asarray(a, np.float32)
    jkde = JKDE.fit(jnp.asarray(rng.normal(1.0, 1.0, (64, d)), jnp.float32))
    theta = f32(rng.normal(0, 1.5, (N, d)))
    y = f32(np.abs(theta) + 0.2 * rng.normal(size=(N, d)))
    logk = np.array(PROB.kernel_log_prob(PROB.discrepancy(jnp.asarray(y))))
    sl = (f32(rng.normal(size=(N, B, d))), f32(rng.normal(1.5, 0.3, (N, B, d))),
          f32(rng.normal(-6.0, 3.0, (N, B))), f32(rng.normal(-2, 1, (N, B))))
    nz = dict(g=f32(-np.log(-np.log(rng.uniform(size=(N, B + 1))))),
              u_local=f32(rng.uniform(size=N)), u_coin=f32(rng.uniform(size=N)),
              l1=f32(rng.normal(size=(N, d))), l2=f32(rng.normal(size=(N, d))))
    kern = PoolISIRMixed(d, np.asarray(PROB.y_obs), epsilon=PROB.epsilon,
                         sigma=PROB._noise_std, global_frequency=gf,
                         batch_size=B, lp_scale=0.35)
    res = resident_from_kde(kde_from_numpy(jkde.X, jkde.weights,
                                           jkde.bandwidth))
    t = torch.from_numpy
    # the pool slice in the kernel's (B, d, C) / (B, C) layout
    sl_k = (t(sl[0]).permute(1, 2, 0), t(sl[1]).permute(1, 2, 0),
            t(sl[2]).T, t(sl[3]).T)
    noise = MixedNoise(t(nz["g"]), t(nz["u_local"]), t(nz["u_coin"]),
                       t(nz["l1"]), t(nz["l2"]))
    # the kernel puts the current state's Gumbel last
    noise = noise._replace(gumbel=torch.cat([noise.gumbel[:, 1:],
                                             noise.gumbel[:, :1]], dim=1))
    (th2, y2, lk2), inc = mixed_transition((t(theta), t(y), t(logk)), sl_k,
                                           res, noise, kern.cfg)
    (r_th, r_y, r_lk), r_inc = _composed_jax_step((theta, y, logk), sl, jkde,
                                                  nz, gf)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th2.numpy(), r_th, **tol)
    np.testing.assert_allclose(y2.numpy(), r_y, **tol)
    np.testing.assert_allclose(lk2.numpy(), r_lk, **tol)
    for a, b in zip(inc, r_inc):
        np.testing.assert_array_equal(a.numpy(), b)
    if gf == 0.5:   # both moves, both outcomes of each
        assert 0 < r_inc[0].sum() < N
        assert 0 < r_inc[1].sum() and 0 < r_inc[2].sum()


def test_mixed_wrapper_checks():
    # the program variant takes only the port's TileProgram
    with pytest.raises(TypeError, match="TileProgram"):
        PoolISIRMixed(2, [1.5, 1.5], program=object())
    kern = PoolISIRMixed(2, [1.5, 1.5], steps_per_call=3, batch_size=2)
    res = resident_from_gaussian([0.0, 0.0], 1.0)
    args = [torch.zeros(3, 2, 2, 32), torch.zeros(3, 2, 2, 32),
            torch.zeros(3, 2, 32), torch.zeros(3, 2, 32),
            torch.zeros(2, 32), torch.zeros(2, 32), torch.zeros(32)]
    out = kern.run(0, res, *args)
    assert len(out) == 7 and out[6].shape == (3, 2, 32)
    assert PoolISIRMixed.launches == 0
    bad = list(args)
    bad[2] = torch.zeros(3, 8, 32)
    with pytest.raises(ValueError, match="pool_logw"):
        kern.run(0, res, *bad)
    with pytest.raises(ValueError, match="mu_scaled"):
        kern.run(0, res._replace(mu_scaled=torch.zeros(1, 3)), *args)
