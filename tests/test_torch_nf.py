"""GLMCMC-NF in glabc_tpu_torch held against glabc_tpu, on the CPU.

* The pool draw (one push of the flow per epoch) and the pool trainer
  (importance resample of the consumed pool, one Adam step; a non-finite
  loss skips the update); a JAX pool and gf=1 fused state carried across
  by the converters, to 1e-5.
* The pooled driver in both cadences (``cursor``, ``slice``) and both coin
  modes; the exact-consumption property of ``tests/test_nf_cadence.py`` (at
  gf=1 a segment consumes its pool exactly once, with no slack).
* The gf=1 fused driver (K3 over flow pools, the state log-weight by one
  pull per epoch), bitwise resume of every driver, and the runner's
  routing.
* The slice as a whole: ``run_glmcmc_nf_pooled`` (cursor and slice
  cadence) and the gf=1 fused driver against glabc_tpu's
  ``run_glmcmc_nf_pooled``, statistically, within limits set from the seed
  spread of each side (``SLICE``; ``PYTHONPATH=. JAX_PLATFORMS=cpu python
  tests/test_torch_nf.py 5`` prints it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glabc_tpu
from glabc_tpu.samplers.glmcmc_nf_fused import \
    run_glmcmc_nf_pooled as j_pooled
from glabc_tpu_torch import DiagGaussian, MCMCRunner, MixtureProblem
from glabc_tpu_torch.models.flows import CouplingFlow
from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush, PoolISIR
from glabc_tpu_torch.samplers.aglmcmc import Pool, default_pool_slack
from glabc_tpu_torch.samplers.glmcmc_nf import (GLMCMCNFConfig,
                                                make_optimizer, run_glmcmc_nf)
from glabc_tpu_torch.samplers.glmcmc_nf_fused import (make_nf_pool_fn,
                                                      make_pool_trainer,
                                                      run_glmcmc_nf_fused,
                                                      run_glmcmc_nf_pooled)

torch.set_num_threads(1)

PROB = MixtureProblem(0.05)
JPROB = glabc_tpu.MixtureProblem(0.05)
LP = DiagGaussian.create(2, 0.0, float(np.log(0.35)))
JLP = glabc_tpu.DiagGaussian.create(2, 0.0, float(np.log(0.35)))
BASE = DiagGaussian.create(2)
SMALL = dict(n_layers=2, hidden=16, device="cpu")


def gen(seed):
    return torch.Generator().manual_seed(seed)


def _flow(seed=0):
    f = CouplingFlow.create(2, 2, 16, generator=gen(seed))
    with torch.no_grad():
        f.w2.normal_(0.0, 0.1, generator=gen(seed + 1))
    return f


# ------------------------------------------------------ pool and trainer
def test_pool_draw_and_trainer():
    f = _flow()
    pool_fn = make_nf_pool_fn(PROB, 8, 5, 3)
    pools = pool_fn(f, gen(1))
    assert isinstance(pools, Pool) and pools.theta.shape == (8, 15, 2)
    assert pools.x.shape == (8, 15, 2) and pools.log_w.shape == (8, 15)
    assert torch.isfinite(pools.log_w).all()
    # log_q is the flow's density of the drawn rows (one push, one pull)
    np.testing.assert_allclose(
        pools.log_q.numpy(), f.log_prob(pools.theta.reshape(-1, 2))
        .reshape(8, 15).numpy(), rtol=1e-4, atol=1e-4)
    cfg = GLMCMCNFConfig(1.0, 3, 4, 10, 2, 16)
    train = make_pool_trainer(cfg, 8, max_train=20)
    opt = make_optimizer(f, cfg)
    before = [p.detach().clone() for p in f.parameters()]
    loss = train(f, opt, pools, gen(2))
    assert torch.isfinite(loss)
    assert any(not torch.equal(a, b) for a, b in zip(before, f.parameters()))
    # a pool of NaN rows gives a NaN loss: the update is skipped
    bad = pools._replace(theta=torch.full_like(pools.theta, float("nan")))
    after = [p.detach().clone() for p in f.parameters()]
    state = {k: v["exp_avg"].clone() for k, v in
             zip(range(8), opt.state.values())}
    loss = train(f, opt, bad, gen(3))
    assert not torch.isfinite(loss)
    assert all(torch.equal(a, b) for a, b in zip(after, f.parameters()))
    assert all(torch.equal(state[k], v["exp_avg"])
               for k, v in zip(range(8), opt.state.values()))


def test_jax_nf_pool_and_fused_state_carry_across():
    """A JAX flow pool and gf=1 fused state, converted: the port's flow
    gives the pool rows the density they were drawn with, and the carried
    state log-weight the JAX driver computed."""
    from glabc_tpu.models.flows import CouplingFlow as JFlow
    from glabc_tpu.samplers.glmcmc_nf_fused import (_make_nf_fused_helpers,
                                                    make_nf_pool_fn as j_pool)
    from glabc_tpu_torch.utils.convert import (coupling_flow_from_numpy,
                                               nf_fused_state_from_numpy,
                                               pool_from_numpy)

    C, T, B = 16, 3, 4
    jf = JFlow.create(jax.random.PRNGKey(0), 2, 2, 16)
    st = jf.stack
    rng = np.random.default_rng(0)
    jf = JFlow(base=jf.base, stack=st.__class__(
        w0=st.w0, b0=st.b0, w1=st.w1, b1=st.b1,
        w2=jnp.asarray(rng.normal(0, 0.1, st.w2.shape), jnp.float32),
        b2=jnp.asarray(rng.normal(0, 0.1, st.b2.shape), jnp.float32)))
    f = coupling_flow_from_numpy(st.w0, st.b0, st.w1, st.b1, jf.stack.w2,
                                 jf.stack.b2, jf.base.loc, jf.base.log_scale)
    pools = pool_from_numpy(*j_pool(JPROB, C, T, B, flow_backend="xla")(
        jf, jax.random.PRNGKey(1)))
    assert pools.theta.shape == (C, T * B, 2)
    np.testing.assert_allclose(
        f.log_prob(pools.theta.reshape(-1, 2)).numpy(),
        pools.log_q.reshape(-1).numpy(), rtol=1e-5, atol=1e-5)
    _, state_logw, state_init, _ = _make_nf_fused_helpers(JPROB, 2, 8, C, T,
                                                          B)
    theta = rng.normal(0, 1.5, (C, 2)).astype(np.float32)
    y = (np.abs(theta) + 0.2 * rng.normal(size=(C, 2))).astype(np.float32)
    logk = np.asarray(JPROB.kernel_log_prob(JPROB.discrepancy(
        jnp.asarray(y))))
    theta_k = state_init(jnp.asarray(theta))
    logw_k = state_logw(jf, theta_k, jnp.asarray(logk))
    th, yy, lk, lw = nf_fused_state_from_numpy(theta_k, y, logk, logw_k, 2)
    assert th.shape == (2, C) and yy.shape == (C, 2) and lw.shape == (C,)
    np.testing.assert_allclose(
        (PROB.prior_log_prob(th.T) + lk - f.log_prob(th.T)).numpy(),
        lw.numpy(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- drivers
def _pooled(seed=0, **kw):
    args = dict(global_frequency=0.5, batch_size=3, step_size=6,
                train_steps=3, num_chains=16, **SMALL)
    args.update(kw)
    return run_glmcmc_nf_pooled(PROB, gen(seed), 49, np.zeros(2), LP,
                                **args)


@pytest.mark.parametrize("cadence", ["cursor", "slice"])
@pytest.mark.parametrize("shared_coin", [False, True])
def test_pooled_cadences_and_coins(cadence, shared_coin):
    FlowPull.launches = FlowPush.launches = 0
    r = _pooled(cadence=cadence, shared_coin=shared_coin)
    assert FlowPull.launches == FlowPush.launches == 0   # plain on the CPU
    assert r.thetas.shape == (16, 49, 2) and np.isfinite(r.thetas).all()
    c = r.counts
    assert np.all(c.global_attempts + c.local_attempts == 48)
    if shared_coin:
        assert len(set(c.global_attempts.tolist())) == 1
    assert 0.3 < c.global_attempts.mean() / 48 < 0.7
    assert len(r.loss_hist) == 3 and np.isfinite(r.loss_hist).all()
    # the cursor counts each chain's global moves since the last epoch
    kk = r.final_carry.kk.numpy()
    assert 0 < kk.sum() and kk.max() <= 12


def test_gf1_pool_consumed_exactly_once_per_segment():
    """At gf=1 the fixed segment is the reference cadence: the cursor hits
    step_size exactly at the segment's end, with no slack."""
    assert default_pool_slack(20, 1.0) == 0
    r = run_glmcmc_nf_pooled(PROB, gen(3), 61, np.zeros(2), LP,
                             global_frequency=1.0, batch_size=3,
                             step_size=20, train_steps=50, num_chains=4,
                             **SMALL)
    assert np.all(r.final_carry.kk.numpy() == 20)
    assert len(r.loss_hist) == 2


def test_fused_gf1_driver_and_thin(tmp_path):
    PoolISIR.launches = 0
    kw = dict(batch_size=3, step_size=8, train_steps=5, num_chains=16,
              **SMALL)
    r = run_glmcmc_nf_fused(PROB, gen(4), 33, np.zeros(2), **kw)
    assert PoolISIR.launches == 0
    assert r.thetas.shape == (16, 33, 2) and np.isfinite(r.thetas).all()
    assert np.all(r.counts.global_attempts == 32)
    assert len(r.loss_hist) == 3
    theta_k, y_cur, logk, logw_k = r.fused_state
    # the carried log-weight is the state's weight under the final flow
    np.testing.assert_allclose(
        logw_k.numpy(),
        (PROB.prior_log_prob(theta_k.T) + logk
         - r.flow.log_prob(theta_k.T)).numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logk.numpy(),
                               PROB.log_kernel_of_y(y_cur).numpy(),
                               rtol=1e-5, atol=1e-5)
    t = run_glmcmc_nf_fused(PROB, gen(4), 33, np.zeros(2), thin=4,
                            history_dtype="bfloat16", **kw)
    assert t.thetas.shape == (16, 9, 2)
    np.testing.assert_allclose(t.thetas, r.thetas[:, ::4], rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("train_on", ["flow_is", "chain_states"])
def test_scan_path_trains_on_either_set(train_on):
    """The per-step path's two training sets: importance-resampled flow
    draws (the reference) or the chains' current states; each epoch takes
    ``train_iters_per_epoch`` Adam steps until ``train_steps`` epochs."""
    r = run_glmcmc_nf(PROB, gen(6), 41, np.zeros(2), LP,
                      global_frequency=0.5, batch_size=3, step_size=4,
                      train_steps=3, num_chains=8, train_on=train_on,
                      train_iters_per_epoch=2, **SMALL)
    assert r.thetas.shape == (8, 41, 2) and np.isfinite(r.thetas).all()
    assert len(r.loss_hist) == 6 and np.isfinite(r.loss_hist).all()
    assert torch.count_nonzero(r.flow.w2) > 0   # the flow left the identity
    with pytest.raises(ValueError, match="train_on"):
        run_glmcmc_nf(PROB, gen(6), 9, np.zeros(2), LP, train_on="pool",
                      **SMALL)


@pytest.mark.parametrize("driver", ["pooled", "fused", "scan"])
def test_resume_is_bitwise(tmp_path, driver):
    if driver == "pooled":
        run = lambda n, g, **k: run_glmcmc_nf_pooled(
            PROB, g, n, np.zeros(2), LP, global_frequency=0.5, batch_size=3,
            step_size=4, train_steps=3, num_chains=8, **SMALL, **k)
    elif driver == "fused":
        run = lambda n, g, **k: run_glmcmc_nf_fused(
            PROB, g, n, np.zeros(2), batch_size=3, step_size=8,
            train_steps=3, num_chains=8, **SMALL, **k)
    else:
        run = lambda n, g, **k: run_glmcmc_nf(
            PROB, g, n, np.zeros(2), LP, global_frequency=0.5, batch_size=3,
            step_size=4, train_steps=3, num_chains=8, **SMALL, **k)
    full = run(41, gen(5))
    ck = str(tmp_path / "ck")
    first = run(25, gen(5), checkpoint_path=ck)
    rest = run(41, gen(77), checkpoint_path=ck, resume=True)
    np.testing.assert_array_equal(first.thetas, full.thetas[:, :25])
    np.testing.assert_array_equal(rest.thetas, full.thetas[:, 25:])
    np.testing.assert_array_equal(rest.loss_hist, full.loss_hist)
    for x, y in zip(rest.counts, full.counts):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="mismatch"):
        run_glmcmc_nf_pooled(PROB, gen(5), 41, np.zeros(2), LP,
                             global_frequency=0.5, batch_size=3,
                             step_size=4, num_chains=4, checkpoint_path=ck,
                             resume=True, **SMALL)


def test_runner_routes_glmcmc_nf(tmp_path):
    runner = MCMCRunner(PROB, output_dir=str(tmp_path), num_chains=16,
                        verbose=False, device="cpu")
    kw = dict(n_layers=2, hidden=16)
    ch = runner.run_glmcmc_nf(17, np.zeros(2), None, 0.5, LP, BASE, 3, 4, 2,
                              **kw)
    assert ch.shape == (16, 17, 2)
    csv = np.loadtxt(tmp_path / "glmcmc_nf_results.csv", delimiter=",")
    np.testing.assert_allclose(csv, ch[0], rtol=1e-6, atol=1e-7)
    for method, gf in (("fused", 1.0), ("fused", 0.5), ("scan", 0.5)):
        ch = runner.run_glmcmc_nf(9, np.zeros(2), None, gf, LP, BASE, 3, 4,
                                  2, output_file=None, method=method, **kw)
        assert ch.shape == (16, 9, 2) and np.isfinite(ch).all()
    assert np.all(runner.last_result.counts.local_attempts > 0)
    with pytest.raises(ValueError, match="slice"):
        runner.run_glmcmc_nf(9, np.zeros(2), None, 0.5, LP, BASE, 3, 4, 2,
                             method="fused", cadence="cursor", **kw)
    with pytest.raises(ValueError, match="method"):
        runner.run_glmcmc_nf(9, np.zeros(2), None, 0.5, LP, BASE, 3, 4, 2,
                             method="xla", **kw)
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_glmcmc_nf_fused(PROB, gen(0), 9, np.zeros(2), mesh=object(),
                            **SMALL)
    if not torch.cuda.is_available():   # no silent fallback to the CPU
        for fn in (run_glmcmc_nf_fused, run_glmcmc_nf_pooled, run_glmcmc_nf):
            args = () if fn is run_glmcmc_nf_fused else (LP,)
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn(PROB, gen(0), 9, np.zeros(2), *args, n_layers=2,
                   hidden=16)


# ------------------------------------------------------------- the slice
# Limits of the whole-slice comparison, set from the spread over 5 seeds of
# each side at these sizes (``python tests/test_torch_nf.py 5``): the
# port's E|theta| after burn-in and global acceptance against JAX's, as
# absolute differences of one run each, about 4 sd of that difference.  The
# sds read: E|theta| 0.0098 (JAX) / 0.0059 (cursor) / 0.0080 (slice) at
# gf=0.5, 0.0232 (JAX) / 0.0106 (fused) at gf=1; global acceptance 0.00094 /
# 0.00093 / 0.00057 at gf=0.5, 0.00048 / 0.00029 at gf=1.
SLICE = dict(chains=64, iters=601, batch=4, step=20, burn=200,
             abs_atol={0.5: 0.05, 1.0: 0.10},
             gacc_atol={0.5: 0.005, 1.0: 0.0025})


def _slice_stats(thetas, counts):
    ch = np.asarray(thetas, np.float64)[:, SLICE["burn"]:]
    g = float(np.sum(counts.global_accepts)
              / max(np.sum(counts.global_attempts), 1))
    return float(np.abs(ch).mean()), g


def _slice_run(side, seed, gf=0.5):
    C, n = SLICE["chains"], SLICE["iters"]
    kw = dict(global_frequency=gf, batch_size=SLICE["batch"],
              step_size=SLICE["step"], train_steps=50, num_chains=C,
              n_layers=2, hidden=16)
    if side == "jax":
        r = j_pooled(JPROB, jax.random.PRNGKey(seed), n, jnp.zeros(2), JLP,
                     **kw)
        counts = jax.tree_util.tree_map(np.asarray, r.counts)
        return _slice_stats(r.thetas, counts)
    if side == "fused":
        kw.pop("global_frequency")
        r = run_glmcmc_nf_fused(PROB, gen(seed), n, np.zeros(2), **kw,
                                device="cpu")
    else:
        r = run_glmcmc_nf_pooled(PROB, gen(seed), n, np.zeros(2), LP,
                                 cadence=side, **kw, device="cpu")
    return _slice_stats(r.thetas, r.counts)


@pytest.fixture(scope="module")
def slice_runs():
    return {("jax", 0.5): _slice_run("jax", 0), ("jax", 1.0):
            _slice_run("jax", 1, 1.0),
            ("cursor", 0.5): _slice_run("cursor", 2),
            ("slice", 0.5): _slice_run("slice", 3),
            ("fused", 1.0): _slice_run("fused", 4, 1.0)}


@pytest.mark.parametrize("side,gf", [("cursor", 0.5), ("slice", 0.5),
                                     ("fused", 1.0)])
def test_slice_matches_jax_statistically(slice_runs, side, gf):
    got, ref = slice_runs[(side, gf)], slice_runs[("jax", gf)]
    assert abs(got[0] - ref[0]) <= SLICE["abs_atol"][gf], (got, ref)
    assert abs(got[1] - ref[1]) <= SLICE["gacc_atol"][gf], (got, ref)


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_nf.py [n]
    import sys

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    for side, gf in (("jax", 0.5), ("cursor", 0.5), ("slice", 0.5),
                     ("jax", 1.0), ("fused", 1.0)):
        rows = np.asarray([_slice_run(side, 100 + s, gf) for s in range(n)])
        print(side, gf, "mean", rows.mean(0).round(5).tolist(), "sd",
              rows.std(0, ddof=1).round(5).tolist(), flush=True)
