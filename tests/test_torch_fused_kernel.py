"""The fused Mixture GLMCMC transition of glabc_tpu_torch held against
glabc_tpu.

(d) One transition of the port's plain ``transition``, fed explicit numpy
    noise, against the same step composed from glabc_tpu's own functions
    (prior, proposal density, epsilon-kernel of the discrepancy, and the
    argmax of the sanitized log-weights plus Gumbels), in the packed and
    unpacked layouts.  rtol 1e-5 (float32 sums in another order), atol 1e-6
    for values near zero.
(e) The Pallas kernels K1 (packed) and K2 (unpacked) themselves, run in
    interpret mode on the CPU.  There every PRNG bit is 0, so every uniform
    is 2^-25; the port's ``transition`` gets that constant noise and both
    packages start from the same state (``utils.convert``).  With
    ``ip_loc = 1.5 - sqrt(50 ln 2)`` the constant candidate lands on y_obs,
    so chains move at step 1.  Agreement at 1e-5 on theta, y, logk, history
    and all four counters, in the kernels' own layouts.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glabc_tpu
from glabc_tpu.ops.pallas.mixture_kernel import FusedMixtureGLMCMC as JFused
from glabc_tpu.ops.pallas.mixture_kernel import fused_state_init as j_fused_init
from glabc_tpu.ops.pallas.packed_kernel import PackedMixtureGLMCMC as JPacked
from glabc_tpu.ops.pallas.packed_kernel import packed_state_init as j_packed_init
from glabc_tpu.ops.pallas.packed_kernel import unpack_history as j_unpack
from glabc_tpu.ops.resampling import sanitize_log_weights
from glabc_tpu_torch.ops.kernels import (FusedMixtureGLMCMC,
                                         PackedMixtureGLMCMC,
                                         fused_state_init, packed_state_init,
                                         unpack_history)
from glabc_tpu_torch.ops.kernels.mixture_kernel import (Noise,
                                                        noise_from_uniforms,
                                                        transition)
from glabc_tpu_torch.utils.convert import (mixture_problem_from_numpy,
                                           state_from_numpy, state_to_numpy)

torch.set_num_threads(1)

B = 5
LP_SCALE = 0.35


def _jax_problem(d, epsilon):
    if d == 2:
        return glabc_tpu.MixtureProblem(epsilon)
    return glabc_tpu.HighDimMixtureProblem(d, epsilon=epsilon)


def _port_kernel(layout, d, jprob, **kw):
    cls = PackedMixtureGLMCMC if layout == "packed" else FusedMixtureGLMCMC
    return cls(d, np.asarray(jprob.y_obs), epsilon=jprob.epsilon,
               sigma=jprob._noise_std, batch_size=B, lp_scale=LP_SCALE, **kw)


def _groups(kern):
    return kern.pack if isinstance(kern, PackedMixtureGLMCMC) else 1


def _to_layout(kern, x_cd):
    """Per-chain ``(N, d)`` numpy -> the layout, by the JAX package's own
    formulas (``packed_kernel.py:330-333``; unpacked: rows >= d are 0)."""
    N, d = x_cd.shape
    if isinstance(kern, PackedMixtureGLMCMC):
        C = N // kern.pack
        return x_cd.reshape(kern.pack, C, d).transpose(0, 2, 1).reshape(8, C)
    out = np.zeros((kern.d_pad, N), np.float32)
    out[:d] = x_cd.T
    return out


def _from_layout(kern, x):
    """Layout -> per-chain ``(N, d)``, decoded with glabc_tpu's
    ``unpack_history`` for the packed layout."""
    if isinstance(kern, PackedMixtureGLMCMC):
        return j_unpack(np.asarray(x)[None], kern.d)[:, 0]
    return np.asarray(x)[:kern.d].T


# --------------------------------------------------------------- (d)
def _composed_jax_step(prob, ip, ip_loc, ip_scale, state, nz, gf, algorithm):
    """One GLMCMC / GlobalMCMC transition built from glabc_tpu's functions,
    on explicit noise."""
    theta, y, logk = (jnp.asarray(x) for x in state)
    sigma = prob._noise_std
    log_k = lambda yy: prob.kernel_log_prob(prob.discrepancy(yy))
    lp_theta = prob.prior_log_prob(theta)
    if algorithm == "glmcmc":
        thp = ip_loc + ip_scale * jnp.asarray(nz["n1"])          # (N, B, d)
        yp = jnp.abs(thp) + sigma * jnp.asarray(nz["n2"])
        lkp = log_k(yp)
        log_w = jnp.concatenate(
            [(lp_theta + logk - ip.log_prob(theta))[:, None],
             prob.prior_log_prob(thp) + lkp - ip.log_prob(thp)], axis=1)
        idx = jnp.argmax(sanitize_log_weights(log_w) + jnp.asarray(nz["g"]),
                         axis=1)
        moved = idx > 0
        pick = jnp.maximum(idx - 1, 0)
        rows = jnp.arange(theta.shape[0])
        w_th = jnp.where(moved[:, None], thp[rows, pick], theta)
        w_y = jnp.where(moved[:, None], yp[rows, pick], y)
        w_lk = jnp.where(moved, lkp[rows, pick], logk)
    else:
        thp = ip_loc + ip_scale * jnp.asarray(nz["n1"][:, 0])
        yp = jnp.abs(thp) + sigma * jnp.asarray(nz["n2"][:, 0])
        lkp = log_k(yp)
        la = (prob.prior_log_prob(thp) + lkp + ip.log_prob(theta)
              - ip.log_prob(thp) - lp_theta - logk)
        moved = jnp.log(jnp.asarray(nz["u_global"])) < la
        w_th = jnp.where(moved[:, None], thp, theta)
        w_y = jnp.where(moved[:, None], yp, y)
        w_lk = jnp.where(moved, lkp, logk)
    thl = theta + LP_SCALE * jnp.asarray(nz["l1"])
    yl = jnp.abs(thl) + sigma * jnp.asarray(nz["l2"])
    lkl = log_k(yl)
    l_acc = jnp.log(jnp.asarray(nz["u_local"])) < (
        prob.prior_log_prob(thl) + lkl - lp_theta - logk)
    is_g = jnp.asarray(nz["u_coin"]) < gf
    out = (jnp.where(is_g[:, None], w_th, jnp.where(l_acc[:, None], thl, theta)),
           jnp.where(is_g[:, None], w_y, jnp.where(l_acc[:, None], yl, y)),
           jnp.where(is_g, w_lk, jnp.where(l_acc, lkl, logk)))
    inc = (jnp.where(is_g, moved, l_acc), is_g, is_g & moved, ~is_g & l_acc)
    return ([np.asarray(x) for x in out],
            [np.asarray(x, np.float32) for x in inc])


LAYOUTS = [(1, "packed"), (1, "unpacked"), (2, "packed"), (2, "unpacked"),
           (3, "unpacked"), (8, "packed"), (8, "unpacked")]


@pytest.mark.parametrize("d,layout", LAYOUTS)
@pytest.mark.parametrize("gf", [0.0, 0.9, 1.0])
@pytest.mark.parametrize("algorithm", ["glmcmc", "global"])
def test_one_transition_matches_composed_jax_step(algorithm, gf, d, layout):
    N = 64
    rng = np.random.default_rng(100 * d + int(10 * gf) + len(algorithm))
    jprob = _jax_problem(d, 0.5)
    ip_loc, ip_scale = 1.0, 0.8
    ip = glabc_tpu.DiagGaussian.create(d, ip_loc, float(np.log(ip_scale)))
    kern = _port_kernel(layout, d, jprob, global_frequency=gf, ip_loc=ip_loc,
                        ip_scale=ip_scale, algorithm=algorithm)
    Bp = B if algorithm == "glmcmc" else 1
    f32 = lambda x: np.asarray(x, np.float32)
    theta = f32(rng.normal(0, 1.5, (N, d)))
    y = f32(np.abs(theta) + jprob._noise_std * rng.normal(size=(N, d)))
    logk = np.array(jprob.kernel_log_prob(jprob.discrepancy(jnp.asarray(y))))
    nz = dict(n1=f32(rng.normal(size=(N, Bp, d))),
              n2=f32(rng.normal(size=(N, Bp, d))),
              l1=f32(rng.normal(size=(N, d))), l2=f32(rng.normal(size=(N, d))),
              g=f32(-np.log(-np.log(rng.uniform(size=(N, B + 1))))),
              u_local=f32(rng.uniform(size=N)), u_coin=f32(rng.uniform(size=N)),
              u_global=f32(rng.uniform(size=N)))

    # the test's layout helper agrees with glabc_tpu's decoder
    np.testing.assert_array_equal(_from_layout(kern, _to_layout(kern, theta)),
                                  theta)
    groups = _groups(kern)
    lay = [torch.from_numpy(_to_layout(kern, x)) for x in (theta, y)]
    lk_lay = kern.from_chains(torch.from_numpy(logk), groups, "logk")
    state = (kern.to_chains(lay[0], groups), kern.to_chains(lay[1], groups),
             kern.to_chains(lk_lay, groups, aux=True))
    t = lambda k: None if nz.get(k) is None else torch.from_numpy(nz[k])
    noise = Noise(t("g") if algorithm == "glmcmc" else None, t("u_local"),
                  t("u_coin"), t("u_global") if algorithm == "global" else None,
                  t("n1"), t("n2"), t("l1"), t("l2"))
    (th2, y2, lk2), inc = transition(state, noise, kern.cfg)

    (r_th, r_y, r_lk), r_inc = _composed_jax_step(
        jprob, ip, ip_loc, ip_scale, (theta, y, logk), nz, gf, algorithm)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _from_layout(kern, kern.from_chains(th2, groups).numpy()), r_th, **tol)
    np.testing.assert_allclose(
        _from_layout(kern, kern.from_chains(y2, groups).numpy()), r_y, **tol)
    np.testing.assert_allclose(lk2.numpy(), r_lk, **tol)
    for got, want in zip(inc, r_inc):
        np.testing.assert_array_equal(got.numpy(), want)
    if gf == 0.9:   # the step exercised both moves and both outcomes
        assert 0 < r_inc[1].sum() < N and 0 < r_inc[0].sum() < N


# ------------------------------------------------------------ layouts
@pytest.mark.parametrize("layout,d", [("packed", 2), ("packed", 1),
                                      ("unpacked", 3)])
def test_state_init_layout_matches_jax(layout, d):
    """With an explicit per-chain y0 the initial state is deterministic:
    both packages must lay it out identically."""
    jprob = _jax_problem(d, 0.5)
    prob = mixture_problem_from_numpy(np.asarray(jprob.y_obs), jprob.epsilon,
                                      jprob._noise_std)
    rng = np.random.default_rng(5)
    theta0 = rng.normal(size=d).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    if layout == "packed":
        pack, cols = 8 // d, 16
        y0 = rng.normal(1.5, 0.3, (pack * cols, d)).astype(np.float32)
        ref = j_packed_init(jprob, jax.random.PRNGKey(0), theta0, cols, pack,
                            y0=y0)
        got = packed_state_init(prob, g, theta0, cols, pack, y0=y0,
                                device="cpu")
        np.testing.assert_array_equal(unpack_history(got[0][None], d),
                                      j_unpack(np.asarray(ref[0])[None], d))
    else:
        y0 = rng.normal(1.5, 0.3, (128, d)).astype(np.float32)
        ref = j_fused_init(jprob, jax.random.PRNGKey(0), theta0, 128, 8, y0=y0)
        got = fused_state_init(prob, g, theta0, 128, 8, y0=y0, device="cpu")
    for a, b in zip(state_to_numpy(got), ref):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- (e)
def _port_constant_noise_run(kern, state, T):
    """T transitions of the port's plain ``transition`` with every uniform
    2^-25, in the kernel's layout."""
    cfg, groups = kern.cfg, _groups(kern)
    th = kern.to_chains(state[0], groups)
    yy = kern.to_chains(state[1], groups)
    lk = kern.to_chains(state[2], groups, aux=True)
    N = th.shape[0]
    u = 2.0 ** -25
    noise = noise_from_uniforms(
        torch.full((N, cfg.n_scalars), u),
        torch.full((N, cfg.n_proposals + 1, cfg.d, 2), u), cfg)
    counters = [torch.zeros(N) for _ in range(4)]
    hist = []
    for _ in range(T):
        (th, yy, lk), inc = transition((th, yy, lk), noise, cfg)
        counters = [c + i for c, i in zip(counters, inc)]
        hist.append(kern.from_chains(th, groups))
    return ([kern.from_chains(th, groups), kern.from_chains(yy, groups),
             kern.from_chains(lk, groups, "logk"), torch.stack(hist)],
            [kern.from_chains(c, groups, "counter") for c in counters])


@pytest.mark.parametrize("algorithm", ["glmcmc", "global"])
@pytest.mark.parametrize("gf", [0.9, 0.0])
@pytest.mark.parametrize("layout,d", [("packed", 2), ("unpacked", 2),
                                      ("unpacked", 3)])
def test_matches_pallas_kernel_in_interpret_mode(layout, d, gf, algorithm):
    T, cols = 4, 128
    jprob = _jax_problem(d, 0.05 if d == 2 else 0.5)
    ip_loc = 1.5 - math.sqrt(50.0 * math.log(2.0))
    kw = dict(epsilon=jprob.epsilon, sigma=jprob._noise_std,
              global_frequency=gf, batch_size=B, ip_loc=ip_loc,
              lp_scale=LP_SCALE, steps_per_call=T, block_chains=cols,
              algorithm=algorithm)
    key = jax.random.PRNGKey(0)
    if layout == "packed":
        jkern = JPacked(d, jprob.y_obs, interpret=True, **kw)
        jstate = j_packed_init(jprob, key, jnp.zeros(d), cols, 8 // d)
    else:
        jkern = JFused(d, jprob.y_obs, interpret=True, **kw)
        jstate = j_fused_init(jprob, key, jnp.zeros(d), cols, jkern.d_pad)
    jth, jy, jlk, jhist, jstats = jkern.run(7, *jstate)

    kern = _port_kernel(layout, d, jprob, global_frequency=gf, ip_loc=ip_loc,
                        steps_per_call=T, algorithm=algorithm)
    state = state_from_numpy([np.asarray(x) for x in jstate], "cpu")
    (th, yy, lk, hist), counters = _port_constant_noise_run(kern, state, T)

    tol = dict(rtol=1e-5, atol=1e-5)
    for name, got, want in (("theta", th, jth), ("y", yy, jy),
                            ("logk", lk, jlk), ("history", hist, jhist)):
        assert got.shape == np.asarray(want).shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **tol)
    for name, got, want in zip(jstats._fields, counters, jstats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **tol)
    # the constant candidate is reachable: the chains left their start
    assert not np.allclose(np.asarray(jhist)[0], np.asarray(jstate[0]))


# ------------------------------------------------------------- wrapper
def test_wrapper_rejects_what_the_kernel_does_not_take():
    kw = dict(epsilon=0.05, sigma=0.2236, steps_per_call=2)
    kern = FusedMixtureGLMCMC(2, [1.5, 1.5], **kw)
    th, y, lk = torch.zeros(8, 32), torch.zeros(8, 32), torch.zeros(1, 32)
    out = kern.run(0, th, y, lk)
    assert out[3].shape == (2, 8, 32) and out[4].accepted.shape == (1, 32)
    with pytest.raises(TypeError):
        kern.run(0, th.double(), y, lk)
    with pytest.raises(ValueError, match="contiguous"):
        kern.run(0, torch.zeros(32, 8).T, y, lk)
    with pytest.raises(ValueError, match="logk"):
        kern.run(0, th, y, torch.zeros(2, 32))
    with pytest.raises(ValueError, match="multiple"):
        kern.run(0, torch.zeros(7, 32), torch.zeros(7, 32), lk)
    with pytest.raises(ValueError, match="no kernel"):
        kern.run(0, *(x.to("meta") for x in (th, y, lk)))
    packed = PackedMixtureGLMCMC(2, [1.5, 1.5], **kw)
    with pytest.raises(ValueError, match="8 rows"):
        packed.run(0, th[:4].contiguous(), y[:4].contiguous(), lk)
    with pytest.raises(ValueError):
        PackedMixtureGLMCMC(3, [1.5] * 3, **kw)
    with pytest.raises(ValueError):
        FusedMixtureGLMCMC(2, [1.5, 1.5], block_chains=100, **kw)
    with pytest.raises(ValueError):
        FusedMixtureGLMCMC(2, [1.5, 1.5], algorithm="nuts", **kw)
