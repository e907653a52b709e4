"""AGLMCMC in glabc_tpu_torch held against glabc_tpu, on the CPU.

* Epoch pieces, on identical inputs: the anneal quantile against
  ``jnp.quantile`` (rtol 1e-6), the annealed thresholds and the fitted
  per-chain KDEs against ``_epoch_redraw`` (rtol 1e-5), the training
  weights and ``_pool_from_proposals`` given carried datasets (rtol 1e-6).
* Fused samplers: ``pack_chunk``, ``block_chains`` and segmenting give
  bitwise-identical chains; resume is bitwise; ``thin`` and bfloat16
  history; the runner's gf<1 keyword rules; a ``mesh=`` that is not a
  ``DeviceMesh`` and a foreign ``tile_program=`` raise.
* The slice as a whole: ``run_aglmcmc(method='fused', device='cpu')`` at
  gf=1 and gf=0.5 against glabc_tpu's ``run_aglmcmc``, statistically: mean
  annealed threshold per epoch, E|theta| after burn-in and the global
  acceptance rate, within limits set from the seed-to-seed spread of each
  side (``SLICE``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glabc_tpu
import glabc_tpu.samplers.aglmcmc as jagl
from glabc_tpu_torch import DiagGaussian, MCMCRunner, MixtureProblem
from glabc_tpu_torch.ops.kernels import PoolISIR, PoolISIRMixed
from glabc_tpu_torch.samplers import aglmcmc as agl
from glabc_tpu_torch.samplers import (run_aglmcmc, run_aglmcmc_fused,
                                      run_aglmcmc_fused_mixed)
from glabc_tpu_torch.utils.convert import pool_from_numpy

torch.set_num_threads(1)

PROB = MixtureProblem(0.05)
JPROB = glabc_tpu.MixtureProblem(0.05)
IP = DiagGaussian.create(2, 0.0, 0.0)
LP = DiagGaussian.create(2, 0.0, float(np.log(0.35)))
JIP = glabc_tpu.DiagGaussian.create(2, 0.0, 0.0)
JLP = glabc_tpu.DiagGaussian.create(2, 0.0, float(np.log(0.35)))


def gen(seed):
    return torch.Generator().manual_seed(seed)


def _jax_pool(rng, C, P):
    th = rng.normal(size=(C, P, 2)).astype(np.float32)
    ip_lq = np.asarray(JIP.log_prob(jnp.asarray(th)))
    pool = jagl._pool_from_proposals(JPROB, jax.random.PRNGKey(1),
                                     jnp.asarray(th.reshape(-1, 2)),
                                     jnp.asarray(ip_lq.reshape(-1)))
    return jagl.Pool(*(a.reshape(C, P, *a.shape[1:]) for a in pool))


# ----------------------------------------------------------- epoch pieces
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_quantile_matches_jnp_quantile(n):
    rng = np.random.default_rng(n)
    x = rng.gamma(2.0, 1.0, (9, n)).astype(np.float32)
    q = np.concatenate([[0.0, 1.0, 0.5], rng.uniform(size=6)]).astype(
        np.float32)
    got = agl.quantile(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    want = np.array([np.asarray(jnp.quantile(jnp.asarray(x[i]), q[i]))
                     for i in range(9)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # one q for one flattened array, as the shared epoch asks
    np.testing.assert_allclose(
        float(agl.quantile(torch.from_numpy(x).reshape(-1),
                           torch.tensor(0.3))),
        float(jnp.quantile(jnp.asarray(x).reshape(-1), 0.3)), rtol=1e-6)


def test_epoch_anneal_and_kde_fit_match_jax():
    """The deterministic part of a per-chain epoch: annealed thresholds,
    training weights and the fitted KDE, given the same pools."""
    rng = np.random.default_rng(0)
    C, P = 8, 250
    jpool = _jax_pool(rng, C, P)
    hat = np.array([1e6, 1e6, 3.0, 2.0, 0.5, 0.2, 0.15, 1.0], np.float32)
    cfg_j = jagl.AGLMCMCConfig(1.0, 5, 50, 0.8, 0.2, 4, 0, 0)
    _, jkde, jhat, _ = jax.jit(jax.vmap(
        lambda k, p, e: jagl._epoch_redraw(JPROB, cfg_j, k, p, e)))(
            jax.random.split(jax.random.PRNGKey(0), C), jpool,
            jnp.asarray(hat))
    pools = pool_from_numpy(*jpool)
    cfg = agl.AGLMCMCConfig(1.0, 5, 50, 0.8, 0.2, 4, 0, 0)
    new_pools, kde, got_hat = agl._epoch_update(PROB, cfg, gen(0), pools,
                                                torch.from_numpy(hat))
    np.testing.assert_allclose(got_hat.numpy(), np.asarray(jhat), rtol=1e-6)
    np.testing.assert_allclose(kde.weights.numpy(), np.asarray(jkde.weights),
                               rtol=1e-5, atol=1e-30)
    # The Silverman factor counts positive weights.  XLA's CPU code flushes
    # float32 subnormals to zero and torch keeps them, so a chain whose
    # training weights reach below 1.2e-38 may count a few more rows here;
    # its bandwidth then differs by (n/n')^(1/6), well under 1%.
    same_n = ((kde.weights > 0).sum(-1).numpy()
              == (np.asarray(jkde.weights) > 0).sum(-1))
    assert same_n.sum() >= C // 2
    bw, jbw = kde.bandwidth.numpy(), np.asarray(jkde.bandwidth)
    np.testing.assert_allclose(bw[same_n], jbw[same_n], rtol=1e-5)
    np.testing.assert_allclose(bw, jbw, rtol=1e-2)
    assert new_pools.theta.shape == (C, P, 2)
    # redrawn rows are prior-supported and carry finite weights
    assert torch.isfinite(new_pools.log_w).all()


def test_pool_weights_given_carried_datasets():
    """``_pool_from_proposals`` and the training weights on one set of
    simulated datasets (NaN proposal rows included)."""
    rng = np.random.default_rng(3)
    th = rng.normal(size=(4, 30, 2)).astype(np.float32)
    th[0, 3] = np.nan
    x = np.abs(th) + 0.2 * rng.normal(size=th.shape).astype(np.float32)
    x[1, 4] = np.nan
    lq = rng.normal(-2, 0.5, (4, 30)).astype(np.float32)

    class Carried:
        """The Mixture problem with its simulator replaced by ``data``."""

        def __init__(self, base, data):
            self.base, self.data = base, data

        def __getattr__(self, name):
            return getattr(self.base, name)

        def simulate(self, *args):
            return self.data

    # the JAX function is per chain (vmapped in its samplers)
    jp = jagl.Pool(*(jnp.stack(a) for a in zip(*(
        jagl._pool_from_proposals(Carried(JPROB, jnp.asarray(x[c])), None,
                                  jnp.asarray(th[c]), jnp.asarray(lq[c]))
        for c in range(4)))))
    tp = agl._pool_from_proposals(Carried(PROB, torch.from_numpy(x)), None,
                                  torch.from_numpy(th), torch.from_numpy(lq))
    for name, a, b in zip(tp._fields, tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    hat = jnp.asarray(np.array([[0.5], [1.0], [2.0], [1e6]], np.float32))
    want = (JPROB.prior_log_prob(jp.theta)
            + JPROB.kernel_log_prob(jp.dis, hat) - jp.log_q)
    got = agl._training_log_w(PROB, tp, torch.from_numpy(np.array(hat)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def test_shared_epoch_threshold_matches_jax():
    rng = np.random.default_rng(5)
    jpool = _jax_pool(rng, 6, 100)
    cfg_j = jagl.AGLMCMCConfig(0.5, 5, 10, 0.8, 0.2, 4, 0, 10)
    _, jkde, jhat = jagl.make_shared_epoch_fn(JPROB, cfg_j, 64)(
        jax.random.PRNGKey(0), jpool, jnp.float32(1e6))
    cfg = agl.AGLMCMCConfig(0.5, 5, 10, 0.8, 0.2, 4, 0, 10)
    pools, kde, hat = agl._shared_epoch_update(
        PROB, cfg, 64, gen(0), pool_from_numpy(*jpool), torch.tensor(1e6),
        redraw_chunk=3)
    np.testing.assert_allclose(float(hat), float(jhat), rtol=1e-6)
    assert kde.X.shape == (64, 2) and kde.batch_shape == ()
    assert pools.theta.shape == (6, 100, 2)
    assert torch.isfinite(pools.log_w).all()


def test_shared_support_keeps_light_rows_past_2_24():
    """The shared KDE's support is resampled over all C * P pool rows.
    With 2^24 rows, half of them (at random) a quarter as heavy as the rest
    (2.4e-8 of the mass each, below half an ulp of a float32 sum near 1),
    those rows make a fifth of the picks.  (Torch's CPU cumsum accumulates
    float32 in double; on the card, where it does not, the same check is
    ``tests/test_torch_gpu.py::test_shared_support_keeps_light_rows``.)"""
    C, P = 1 << 12, 1 << 12
    # at random, not alternating: systematic resampling aliases a period
    light = torch.rand((C, P), generator=gen(1)) < 0.5
    theta = torch.zeros((C, P, 2))
    theta[..., 0] = light.float() * 1e-3          # a marker, ~no prior change
    zeros = torch.zeros((C, P))
    log_q = torch.where(light, torch.full_like(zeros, float(np.log(4.0))),
                        zeros)
    pools = agl.Pool(theta, theta, zeros, log_q, zeros)
    picks = agl._shared_support(PROB, pools, torch.tensor(1.0), 4096, gen(0))
    share = float((picks[:, 0] > 5e-4).float().mean())
    assert abs(share - 0.2) < 0.02, share


# ------------------------------------------------------- fused samplers
KW = dict(step_size=20, num_chains=64, device="cpu")
MKW = dict(global_frequency=0.5, step_size=10, num_chains=64,
           shared_support=64, device="cpu")


def _equal(a, b):
    np.testing.assert_array_equal(a.thetas, b.thetas)
    for x, y in zip(a.counts, b.counts):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("variant", [dict(pack_chunk=5),
                                     dict(block_chains=32)])
def test_fused_gf1_bitwise_determinism(variant):
    base = run_aglmcmc_fused(PROB, gen(1), 81, np.zeros(2), IP, **KW)
    _equal(base, run_aglmcmc_fused(PROB, gen(1), 81, np.zeros(2), IP, **KW,
                                   **variant))


def test_fused_gf1_segmenting_and_ragged_tail():
    """A longer run starts with the shorter one; a ragged final segment
    keeps the history exactly num_ite long."""
    short = run_aglmcmc_fused(PROB, gen(2), 61, np.zeros(2), IP, **KW)
    long = run_aglmcmc_fused(PROB, gen(2), 91, np.zeros(2), IP, **KW)
    np.testing.assert_array_equal(short.thetas, long.thetas[:, :61])
    assert long.thetas.shape == (64, 91, 2)
    assert long.hat_eps_hist.shape == (4, 64)
    np.testing.assert_array_equal(long.counts.global_attempts, 90)


def test_fused_mixed_bitwise_determinism():
    base = run_aglmcmc_fused(PROB, gen(3), 81, np.zeros(2), IP, **MKW)
    _equal(base, run_aglmcmc_fused(PROB, gen(3), 81, np.zeros(2), IP,
                                   block_chains=32, **MKW))
    long = run_aglmcmc_fused(PROB, gen(3), 101, np.zeros(2), IP, **MKW)
    np.testing.assert_array_equal(base.thetas, long.thetas[:, :81])
    c = long.counts
    np.testing.assert_array_equal(c.global_attempts + c.local_attempts, 100)
    assert 0.4 < c.global_attempts.mean() / 100 < 0.6


@pytest.mark.parametrize("which", ["fused", "mixed", "scan"])
def test_resume_is_bitwise(tmp_path, which):
    ck = str(tmp_path / f"{which}_ckpt")
    if which == "scan":
        run = lambda n, g, **k: run_aglmcmc(PROB, g, n, np.zeros(2), LP, IP,
                                            0.5, 5, 10, num_chains=16,
                                            device="cpu", **k)
    else:
        kw = KW if which == "fused" else MKW
        run = lambda n, g, **k: run_aglmcmc_fused(PROB, g, n, np.zeros(2),
                                                  IP, **kw, **k)
    full = run(81, gen(4))
    run(41, gen(4), checkpoint_path=ck)
    rest = run(81, gen(99), checkpoint_path=ck, resume=True)
    np.testing.assert_array_equal(rest.thetas, full.thetas[:, 41:])
    for a, b in zip(rest.counts, full.counts):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rest.hat_eps_hist, full.hat_eps_hist)
    with pytest.raises(ValueError, match="mismatch"):
        run_aglmcmc_fused(PROB, gen(4), 81, np.zeros(2), IP, step_size=40,
                          num_chains=64, global_frequency=(
                              1.0 if which == "fused" else 0.5),
                          checkpoint_path=ck, resume=True, device="cpu")


@pytest.mark.parametrize("kw", [KW, MKW])
def test_thin_and_bfloat16_history(kw):
    full = run_aglmcmc_fused(PROB, gen(5), 41, np.zeros(2), IP, **kw)
    thin = run_aglmcmc_fused(PROB, gen(5), 41, np.zeros(2), IP, thin=3, **kw)
    np.testing.assert_array_equal(thin.thetas, full.thetas[:, ::3])
    bf = run_aglmcmc_fused(PROB, gen(5), 41, np.zeros(2), IP,
                           history_dtype="bfloat16", **kw)
    assert bf.thetas.dtype == np.float32
    np.testing.assert_array_equal(
        bf.thetas, torch.from_numpy(full.thetas).bfloat16().float().numpy())
    with pytest.raises(ValueError, match="on_segment"):
        run_aglmcmc_fused(PROB, gen(5), 41, np.zeros(2), IP, thin=2,
                          on_segment=lambda b, i: None, **kw)
    with pytest.raises(ValueError, match="bfloat16"):
        run_aglmcmc_fused(PROB, gen(5), 41, np.zeros(2), IP,
                          history_dtype="float16", **kw)


def test_collect_history_off_and_on_segment():
    off = run_aglmcmc_fused(PROB, gen(6), 41, np.zeros(2), IP,
                            collect_history=False, **KW)
    assert off.thetas.shape == (64, 1, 2)
    seen = []
    res = run_aglmcmc_fused(PROB, gen(6), 41, np.zeros(2), IP,
                            on_segment=lambda b, i: seen.append((i, b)), **KW)
    assert [i for i, _ in seen] == [0, 20]
    np.testing.assert_array_equal(np.concatenate([b for _, b in seen], 1),
                                  res.thetas[:, 1:])


def test_runner_gf_lt_1_keyword_rules(tmp_path, monkeypatch):
    import glabc_tpu_torch.runner as runner_mod

    runner = MCMCRunner(PROB, output_dir=str(tmp_path), num_chains=32,
                        verbose=False, device="cpu")
    args = (41, np.zeros(2), None, 0.5, LP, IP, 5, 10, 0.8, 0.2)
    with pytest.raises(ValueError, match="shared"):
        runner.run_aglmcmc(*args, method="fused", shared_adaptation=False)
    with pytest.raises(ValueError, match="epoch_chunk"):
        runner.run_aglmcmc(*args, method="fused", epoch_chunk=8)
    seen = {}
    real = runner_mod.run_aglmcmc_fused

    def spy(*a, **k):
        seen.update(k)
        return real(*a, **k)
    monkeypatch.setattr(runner_mod, "run_aglmcmc_fused", spy)
    ch = runner.run_aglmcmc(*args, method="fused", shared_adaptation=True,
                            shared_support=64)
    assert seen["lp_scale"] == pytest.approx(0.35)
    assert "shared_adaptation" not in seen
    assert ch.shape == (32, 41, 2)
    csv = np.loadtxt(tmp_path / "aglmcmc_results.csv", delimiter=",")
    np.testing.assert_allclose(csv, ch[0], rtol=1e-6, atol=1e-7)
    runner.run_aglmcmc(*args, method="fused", lp_scale=0.2, shared_support=64)
    assert seen["lp_scale"] == 0.2
    ch = runner.run_aglmcmc(*args[:3], 1.0, *args[4:], method="scan")
    assert ch.shape == (32, 41, 2)
    with pytest.raises(ValueError, match="method"):
        runner.run_aglmcmc(*args, method="pallas")


def test_unported_options_raise():
    # mesh= is ported: a mesh that is not a 1-D DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_aglmcmc(PROB, gen(0), 5, np.zeros(2), LP, IP, mesh=object(),
                    device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_aglmcmc_fused(PROB, gen(0), 5, np.zeros(2), IP, mesh=object(),
                          device="cpu")
    # tile_program= is ported: a program that is not the port's is refused
    with pytest.raises(TypeError, match="TileProgram"):
        run_aglmcmc_fused_mixed(PROB, gen(0), 5, np.zeros(2), IP,
                                global_frequency=0.5, tile_program=object(),
                                device="cpu")
    with pytest.raises(ValueError, match="DiagGaussian"):
        run_aglmcmc_fused_mixed(PROB, gen(0), 5, np.zeros(2), object(),
                                global_frequency=0.5, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_aglmcmc_fused(PROB, gen(0), 5, np.zeros(2), IP)
    assert PoolISIR.launches == PoolISIRMixed.launches == 0


# -------------------------------------------------------- the slice whole
# Chains per run, and the limits on port - JAX, set from five seeds of each
# side (``_slice_spread``) at 128 chains (gf=1) and 512 (gf=0.5), 601
# iterations:
#   gf=1:   global acceptance port/JAX - 1 from -4.9 % to +4.7 % (sd 4 %);
#           per-epoch mean threshold within 0.009; E|theta| within 0.007;
#   gf=0.5: global acceptance port/JAX - 1 from -1.2 % to +3.1 % (sd 1.8 %;
#           at 128 chains the shared threshold's noise spread it to 15 %);
#           per-epoch threshold within 0.022; E|theta| within 0.008.
# The limits hold a global move that accepts 20 % more or less often to a
# failure.
SLICE = {"gf1": dict(chains=128, acc_rel=0.12, eps_atol=0.02, abs_atol=0.03),
         "gf05": dict(chains=512, acc_rel=0.08, eps_atol=0.04,
                      abs_atol=0.03)}


@pytest.fixture(scope="module")
def slice_runs():
    C1, C05 = SLICE["gf1"]["chains"], SLICE["gf05"]["chains"]
    out = {"port_gf1": run_aglmcmc_fused(
        PROB, gen(7), 601, np.zeros(2), IP, step_size=100, num_chains=C1,
        device="cpu"),
        "port_gf05": run_aglmcmc_fused(
        PROB, gen(7), 601, np.zeros(2), IP, global_frequency=0.5,
        step_size=50, num_chains=C05, shared_support=256, device="cpu"),
        "jax_gf1": jagl.run_aglmcmc(
        JPROB, jax.random.PRNGKey(0), 601, jnp.zeros(2), JLP, JIP, 1.0, 5,
        100, 0.8, 0.2, num_chains=C1),
        "jax_gf05": jagl.run_aglmcmc(
        JPROB, jax.random.PRNGKey(0), 601, jnp.zeros(2), JLP, JIP, 0.5, 5,
        50, 0.8, 0.2, num_chains=C05, shared_adaptation=True,
        shared_support=256)}
    return out


@pytest.mark.parametrize("gf", ["gf1", "gf05"])
def test_slice_matches_jax_statistically(slice_runs, gf):
    lim = SLICE[gf]
    port, ref = slice_runs[f"port_{gf}"], slice_runs[f"jax_{gf}"]
    assert port.thetas.shape == np.asarray(ref.thetas).shape
    eps_p = np.asarray(port.hat_eps_hist, np.float64).reshape(5, -1).mean(1)
    eps_j = np.asarray(ref.hat_eps_hist, np.float64).reshape(5, -1).mean(1)
    np.testing.assert_allclose(eps_p, eps_j, atol=lim["eps_atol"])
    a_p = np.abs(port.thetas[:, 200:]).mean(dtype=np.float64)
    a_j = np.abs(np.asarray(ref.thetas)[:, 200:]).mean(dtype=np.float64)
    assert abs(a_p - a_j) < lim["abs_atol"], (a_p, a_j)
    assert 1.3 < a_p < 1.55
    g_p = port.acceptance_rates()["global"].mean()
    g_j = ref.acceptance_rates()["global"].mean()
    assert abs(g_p / g_j - 1.0) < lim["acc_rel"], (g_p, g_j)


def _slice_spread(seeds):
    """The readings behind ``SLICE``: each side of the whole-slice test over
    ``seeds``, port/JAX ratio of the global acceptance, largest per-epoch
    threshold and E|theta| differences."""
    for gf, lim in SLICE.items():
        g = 1.0 if gf == "gf1" else 0.5
        step = 100 if gf == "gf1" else 50
        kw = {} if gf == "gf1" else dict(shared_support=256)
        jkw = {} if gf == "gf1" else dict(shared_adaptation=True,
                                          shared_support=256)
        for s in seeds:
            port = run_aglmcmc_fused(
                PROB, gen(s), 601, np.zeros(2), IP, global_frequency=g,
                step_size=step, num_chains=lim["chains"], device="cpu", **kw)
            ref = jagl.run_aglmcmc(
                JPROB, jax.random.PRNGKey(s), 601, jnp.zeros(2), JLP, JIP, g,
                5, step, 0.8, 0.2, num_chains=lim["chains"], **jkw)
            eps = [np.asarray(r.hat_eps_hist, np.float64).reshape(5, -1)
                   .mean(1) for r in (port, ref)]
            a = [np.abs(np.asarray(r.thetas)[:, 200:]).mean(dtype=np.float64)
                 for r in (port, ref)]
            acc = [float(r.acceptance_rates()["global"].mean())
                   for r in (port, ref)]
            print(f"{gf} {lim['chains']} chains seed {s}: global acceptance "
                  f"port {acc[0]:.5f} JAX {acc[1]:.5f} (ratio - 1 "
                  f"{acc[0] / acc[1] - 1:+.2%}); max threshold diff "
                  f"{np.abs(eps[0] - eps[1]).max():.4f}; E|theta| diff "
                  f"{abs(a[0] - a[1]):.4f}", flush=True)


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_aglmcmc.py [n]
    import sys

    _slice_spread(range(int(sys.argv[1]) if len(sys.argv) > 1 else 5))
