"""``mesh=`` (chain sharding over ``torch.distributed``) on the CPU, in one
real 2-rank gloo group.

The module spawns the group once (``torch.multiprocessing``, a
``FileStore`` under a temporary directory, no TCP port), runs every check
inside it and writes each rank's results to an ``.npz``; the tests below
read them, one case each.  The children import torch and the port only
(JAX is imported lazily, in the parent's tests); each records whether
any JAX module was loaded.  A child that hangs fails the module after
``JOIN_TIMEOUT_S``.

* The chain offset: every sampling kernel's plain version launched over a
  chain range and over its halves with ``chain0`` joins to the same bits
  (K1 packed, K2, K3, K5 with both local moves, K6 and K9 with both coins,
  K8; ``chip_smoke.split_cases``), and the halves without the offset do
  not.
* Exact sharding: the fused drivers and the plain chain paths on 2 ranks
  return the 1-rank (``mesh=None``) result bit for bit, on every rank;
  checkpoints are one file a rank, resume bitwise, and a resume on
  another world size raises; so do ``CheckpointManager(mesh=)``'s.
* Collectives: ``distributed_quantile`` against JAX's under ``shard_map``
  on a 2-device mesh (float32, rtol 1e-6) and, through its radix select,
  against ``quantile`` of the joined shards (exact, on ties, NaN, inf,
  signed zeros, one value a rank, order statistics on two ranks);
  ``sharded_hat_eps_update`` and ``distributed_systematic_resample``
  against the one-device rules on the joined inputs (exact; the resample
  also with a rank of no weight, NaN and negative weights, all weight on
  one rank, and one owner a grid point); the data-parallel Adam step against one step on
  the whole batch (1e-6); the shared epoch's KDE the same on both ranks.
* In distribution only: AGLMCMC (per-chain and shared adaptation, plain
  and fused) and GLMCMC-NF (plain, pooled, fused) under ``mesh=`` run,
  stay finite, anneal or train, and keep the flow the same on every rank.
* Every entry point given a ``mesh=`` that is not a 1-D ``DeviceMesh``
  raises ``TypeError`` (in the parent, no group needed).
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

WORLD = 2
JOIN_TIMEOUT_S = 300
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT_C, SPLIT_T = 64, 4
QS = (0.0, 0.3, 0.5, 0.97, 1.0)

# the runs compared bit for bit with mesh=None
EXACT = ("glmcmc_fused_packed", "glmcmc_fused_d3", "global_mcmc_fused",
         "fused_program_mixture", "fused_program_ma2", "glmala_fused_shared",
         "glmala_fused_per_chain", "glmala_program_shared",
         "glmala_program_per_chain", "glmcmc_plain", "global_mcmc_plain",
         "glmala_plain")
# the runs held to finiteness and adaptation only
IN_DISTRIBUTION = ("aglmcmc_per_chain", "aglmcmc_shared", "aglmcmc_fused",
                   "aglmcmc_fused_mixed", "nf_flow_is", "nf_chain_states",
                   "nf_pooled", "nf_fused")


def _quantile_input():
    return np.random.default_rng(0).normal(size=(WORLD, 128)).astype(
        np.float32)


def _weights_input():
    return np.random.default_rng(1).uniform(size=(WORLD, 32))


def _radix_inputs():
    """Each case's shards ``(WORLD, m)`` float32 for the radix-select
    quantile: ``split_ranks`` puts ``lo_i`` (q = 0.5) at rank 0's largest
    value and ``hi_i`` at rank 1's smallest, in other top digits."""
    from glabc_tpu_torch.samplers.aglmcmc import _NAN_DIS

    rng = np.random.default_rng(5)
    ties = rng.exponential(size=(WORLD, 256))
    ties[:, ::2] = _NAN_DIS
    nan_inf = rng.normal(size=(WORLD, 128))
    nan_inf[:, ::5] = np.nan
    nan_inf[:, 1::7] = np.inf
    zeros = np.tile([0.0, -0.0, 1.5, -0.0, -2.0, 0.0], (WORLD, 8))
    split = rng.uniform(1.0, 2.0, size=(WORLD, 64))
    split[1:] *= 1000.0
    cases = {"normal": _quantile_input(), "bulk_ties": ties,
             "all_equal": np.full((WORLD, 64), 0.25),
             "nan_inf": nan_inf, "signed_zeros": zeros,
             "one_a_rank": rng.normal(size=(WORLD, 1)),
             "split_ranks": split}
    return {k: v.astype(np.float32) for k, v in cases.items()}


def _resample_inputs():
    """Each case's weight shards ``(WORLD, 32)``: a rank with no weight,
    NaN and negative weights, all the weight on the last rank."""
    rng = np.random.default_rng(6)
    zero_rank = rng.uniform(size=(WORLD, 32))
    zero_rank[0] = 0.0
    nan_neg = rng.uniform(size=(WORLD, 32))
    nan_neg[:, ::3] = np.nan
    nan_neg[:, 1::5] = -1.0
    one_rank = np.zeros((WORLD, 32))
    one_rank[-1] = rng.uniform(size=32)
    return {"uniform": _weights_input(), "zero_rank": zero_rank,
            "nan_negative": nan_neg, "one_rank": one_rank}


def _same(a, b):
    """Equal values (a zero of either sign equal), or both NaN."""
    return bool(torch.equal(a, b) or (torch.isnan(a).all()
                                      and torch.isnan(b).all()))


def _split_names():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return [n for n, _ in chip_smoke.split_cases("cpu", 8, 1)]


# ------------------------------------------------------- the children
def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _save_run(out, key, res):
    out[f"{key}.thetas"] = res.thetas
    for f, v in res.counts._asdict().items():
        out[f"{key}.counts.{f}"] = np.asarray(v)


def _check_split(rank, mesh, out, tmp):
    sys.path.insert(0, ROOT)
    import chip_smoke

    cases = chip_smoke.split_cases("cpu", SPLIT_C, SPLIT_T, seed=3)
    for name, run in cases[rank::WORLD]:
        out[f"split.{name}"] = chip_smoke.split_matches(run, SPLIT_C)[0]
        out[f"split_control.{name}"] = chip_smoke.split_matches(
            run, SPLIT_C, offset=False)[0]


def _exact_runs(rank, mesh, out, tmp):
    from glabc_tpu_torch import (DiagGaussian, HighDimMixtureProblem,
                                 MA2Problem, MixtureProblem,
                                 mixture_tile_program, run_fused_program,
                                 run_global_mcmc, run_global_mcmc_fused,
                                 run_glmala, run_glmala_fused,
                                 run_glmala_program, run_glmcmc,
                                 run_glmcmc_fused)

    p2, p3, ma2 = (MixtureProblem(0.05), HighDimMixtureProblem(3),
                   MA2Problem())
    ip = DiagGaussian.create(2, 0.0, 0.0)
    lp = DiagGaussian.create(2, 0.0, float(np.log(0.35)))
    z2 = np.zeros(2)
    cpu = dict(device="cpu")
    runs = {
        # 128 chains a rank = pack 4 x 32: packed on both world sizes
        "glmcmc_fused_packed": lambda m: run_glmcmc_fused(
            p2, _gen(1), 20, z2, num_chains=256, steps_per_call=8,
            block_chains=32, kernel="auto", mesh=m, **cpu),
        "glmcmc_fused_d3": lambda m: run_glmcmc_fused(
            p3, _gen(2), 12, np.zeros(3), num_chains=32, steps_per_call=4,
            mesh=m, **cpu),
        "global_mcmc_fused": lambda m: run_global_mcmc_fused(
            p2, _gen(3), 12, z2, num_chains=32, steps_per_call=4,
            global_frequency=0.5, mesh=m, **cpu),
        "fused_program_mixture": lambda m: run_fused_program(
            p2, mixture_tile_program(p2), _gen(4), 10, z2, num_chains=32,
            steps_per_call=4, mesh=m, **cpu),
        "fused_program_ma2": lambda m: run_fused_program(
            ma2, ma2.tile_program(), _gen(5), 6, z2, num_chains=16,
            steps_per_call=4, mesh=m, **cpu),
        "glmala_fused_shared": lambda m: run_glmala_fused(
            p2, _gen(6), 10, z2, num_chains=32, steps_per_call=4,
            num_grad=6, mesh=m, **cpu),
        "glmala_fused_per_chain": lambda m: run_glmala_fused(
            p2, _gen(7), 10, z2, num_chains=32, steps_per_call=4,
            num_grad=6, coin_mode="per_chain", mesh=m, **cpu),
        "glmala_program_shared": lambda m: run_glmala_program(
            p2, mixture_tile_program(p2), _gen(8), 8, z2, num_chains=16,
            steps_per_call=4, num_grad=4, mesh=m, **cpu),
        "glmala_program_per_chain": lambda m: run_glmala_program(
            p2, mixture_tile_program(p2), _gen(9), 8, z2, num_chains=16,
            steps_per_call=4, num_grad=4, coin_mode="per_chain", mesh=m,
            **cpu),
        "glmcmc_plain": lambda m: run_glmcmc(
            p2, _gen(10), 12, z2, ip, lp, 0.9, 5, num_chains=16,
            segment_size=5, mesh=m, **cpu),
        "global_mcmc_plain": lambda m: run_global_mcmc(
            p2, _gen(11), 12, z2, ip, lp, 0.5, num_chains=16, mesh=m, **cpu),
        "glmala_plain": lambda m: run_glmala(
            p2, _gen(12), 8, z2, ip, num_grad=4, num_chains=16, mesh=m,
            **cpu),
    }
    assert tuple(runs) == EXACT
    for name, run in runs.items():
        _save_run(out, f"{name}.mesh", run(mesh))
        if rank == 0:
            _save_run(out, f"{name}.ref", run(None))


def _checkpoints(rank, mesh, out, tmp):
    """Fused and plain: a run saved part way and resumed under the mesh
    gives the uninterrupted run's history; one file a rank; a resume on
    another world size raises."""
    from glabc_tpu_torch import (DiagGaussian, MixtureProblem, run_glmcmc,
                                 run_glmcmc_fused)

    prob, z2 = MixtureProblem(0.05), np.zeros(2)
    ip = DiagGaussian.create(2, 0.0, 0.0)
    lp = DiagGaussian.create(2, 0.0, float(np.log(0.35)))
    fused = lambda n, **kw: run_glmcmc_fused(
        prob, _gen(20), n, z2, num_chains=32, steps_per_call=4, mesh=mesh,
        device="cpu", **kw)
    plain = lambda n, **kw: run_glmcmc(
        prob, _gen(21), n, z2, ip, lp, 0.9, 5, num_chains=16,
        segment_size=5, mesh=mesh, device="cpu", **kw)
    for name, run, cut, total in (("fused", fused, 9, 17),
                                  ("plain", plain, 11, 21)):
        path = os.path.join(tmp, f"ckpt_{name}")
        full = run(total)
        run(cut, checkpoint_path=path)
        resumed = run(total, checkpoint_path=path, resume=True)
        out[f"ckpt.{name}.resumed"] = resumed.thetas
        out[f"ckpt.{name}.tail"] = full.thetas[:, cut:]
        out[f"ckpt.{name}.own_file"] = os.path.exists(
            f"{path}.rank{rank}.npz") and not os.path.exists(f"{path}.npz")
        if rank == 0:   # another world size: one rank, no collective
            try:
                (run_glmcmc_fused(prob, _gen(20), total, z2, num_chains=32,
                                  steps_per_call=4, checkpoint_path=path,
                                  resume=True, device="cpu")
                 if name == "fused" else
                 run_glmcmc(prob, _gen(21), total, z2, ip, lp, 0.9, 5,
                            num_chains=16, segment_size=5,
                            checkpoint_path=path, resume=True,
                            device="cpu"))
                out[f"ckpt.{name}.other_world_raises"] = False
            except ValueError:
                out[f"ckpt.{name}.other_world_raises"] = True


def _checkpoint_manager(rank, mesh, out, tmp):
    """``CheckpointManager(mesh=)``: K1's loop state (each rank its own
    chains) saved after 1 of 3 launches into one directory, one file a
    rank, restored and run on (``chip_smoke.checkpoint_resume``); then
    the directory refused without the mesh, and a directory written
    without a mesh refused by the mesh."""
    import torch.distributed as dist
    from glabc_tpu_torch.utils import CheckpointManager

    sys.path.insert(0, ROOT)
    import chip_smoke

    directory = os.path.join(tmp, "manager")
    straight, resumed, step = chip_smoke.checkpoint_resume(
        "cpu", directory, chains=64, launches=3, cut=1, T=8, mesh=mesh)
    out["mgr.bitwise"] = all(torch.equal(a, b)
                             for a, b in zip(straight, resumed))
    out["mgr.step"] = step
    out["mgr.files"] = sorted(os.listdir(directory))
    plain_dir = os.path.join(tmp, "manager_plain")
    dist.barrier()
    if rank == 0:   # another world size: one process, no mesh
        with CheckpointManager(directory) as mgr:
            try:
                mgr.restore()
                out["mgr.no_mesh_raises"] = False
            except ValueError:
                out["mgr.no_mesh_raises"] = True
            with CheckpointManager(plain_dir) as plain:
                plain.save(1, {"x": np.arange(3)}, wait=True)
    dist.barrier()
    with CheckpointManager(plain_dir, mesh=mesh) as mgr:
        try:
            mgr.restore()
            out["mgr.mesh_raises"] = False
        except ValueError:
            out["mgr.mesh_raises"] = True


def _collectives(rank, mesh, out, tmp):
    import torch.distributed as dist
    from glabc_tpu_torch import CouplingFlow, MixtureProblem
    from glabc_tpu_torch.ops.resampling import systematic_resample
    from glabc_tpu_torch.parallel import (distributed_quantile,
                                          distributed_systematic_resample,
                                          make_sharded_chain_state_trainer,
                                          make_sharded_shared_epoch,
                                          sharded,
                                          sharded_hat_eps_update)
    from glabc_tpu_torch.samplers import aglmcmc as agl
    from glabc_tpu_torch.samplers.glmcmc_nf import (GLMCMCNFConfig,
                                                    adam_step,
                                                    make_optimizer)

    x = torch.from_numpy(_quantile_input())
    out["quantile"] = np.array([float(distributed_quantile(x[rank], q, mesh))
                                for q in QS], np.float32)
    # the anneal over the joined pools, against the one-device rule
    cfg = agl.AGLMCMCConfig(1.0, 5, 10, 0.8, 0.2, 4, 0, 0)
    for h in (1.0e6, 1.5, 0.1):
        hat = torch.tensor(h, dtype=torch.float32)
        got = sharded_hat_eps_update(0.8, 0.2, mesh)(x[rank].abs(), hat)
        want = agl._anneal(x.abs().reshape(-1), hat, cfg)
        out[f"anneal.{h}"] = bool(torch.equal(got, want))

    # the radix select against the quantile of the joined shards, with no
    # gather of the values
    gather = sharded.gather_chains
    sharded.gather_chains = None
    try:
        for case, xs in _radix_inputs().items():
            xs = torch.from_numpy(xs)
            out[f"radix.{case}"] = np.array([_same(
                distributed_quantile(xs[rank], q, mesh),
                agl.quantile(xs.reshape(-1), q)) for q in QS])
    finally:
        sharded.gather_chains = gather

    w = torch.from_numpy(_weights_input())
    for replicated in (False, True):
        got = distributed_systematic_resample(
            w[rank], 16, mesh, _gen(7), replicated=replicated)
        n = 16 if replicated else 16 * WORLD
        want = systematic_resample(w.reshape(-1) / w.sum(), n, _gen(7))
        if not replicated:
            want = want[16 * rank:16 * (rank + 1)]
        out[f"resample.replicated={replicated}"] = bool(
            torch.equal(got, want))
    # the rank-local CDF against the gathered one: indices, and one owner
    # for every grid point
    for case, ws in _resample_inputs().items():
        ws = torch.from_numpy(ws)
        joined = ws.reshape(-1)
        joined = torch.where(torch.isnan(joined) | (joined < 0),
                             torch.zeros_like(joined), joined)
        for replicated in (False, True):
            key = f"{case}.replicated={replicated}"
            got = distributed_systematic_resample(
                ws[rank], 16, mesh, _gen(8), replicated=replicated)
            n = 16 if replicated else 16 * WORLD
            want = systematic_resample(joined / joined.sum(), n, _gen(8))
            if not replicated:
                want = want[16 * rank:16 * (rank + 1)]
            out[f"local_cdf.{key}"] = bool(torch.equal(got, want))
            # the grid and u = 0, which lies on a boundary of the CDF when
            # the first rank has no weight
            u = (torch.rand((), generator=_gen(8), dtype=torch.float64)
                 + torch.arange(n, dtype=torch.float64)) / n
            u = torch.cat([u, torch.zeros(1, dtype=torch.float64)])
            local = torch.nan_to_num(ws[rank], nan=0.0).clamp_min(0.0)
            owned, idx = sharded._owned_indices(local, u, mesh)
            owners = sharded._all_sum(owned.to(torch.int64), mesh)
            idx = sharded._all_sum(torch.where(owned, idx, 0), mesh)
            c = torch.cumsum(joined / joined.sum(), dim=0)
            want = torch.clamp(torch.searchsorted(c, u, right=True), 0,
                               joined.numel() - 1)
            out[f"owners.{key}"] = bool((owners == 1).all()
                                        and torch.equal(idx, want))

    # the data-parallel Adam step against one step on the whole batch
    cfg_nf = GLMCMCNFConfig(n_layers=2, hidden=16)
    states = torch.from_numpy(np.random.default_rng(2).normal(
        size=(WORLD * 32, 2)).astype(np.float32))
    flows = [CouplingFlow.create(2, 2, 16, generator=_gen(30))
             for _ in range(2)]
    opts = [make_optimizer(f, cfg_nf) for f in flows]
    loss = make_sharded_chain_state_trainer(mesh)(
        flows[0], opts[0], states[32 * rank:32 * (rank + 1)])
    loss_whole = adam_step(flows[1], opts[1], states)
    out["adam.loss"] = np.array([float(loss), float(loss_whole)])
    out["adam.max_param_diff"] = max(
        float((a - b).abs().max()) for a, b in zip(flows[0].parameters(),
                                                   flows[1].parameters()))
    out["adam.max_param_step"] = max(
        float((a - b).abs().max()) for a, b in zip(
            flows[1].parameters(),
            CouplingFlow.create(2, 2, 16, generator=_gen(30)).parameters()))

    # the shared epoch: the same KDE on both ranks
    prob = MixtureProblem(0.05)
    cfg = agl.AGLMCMCConfig(0.5, 5, 4, 0.8, 0.2, 4, 0, 0)
    g = _gen(40 + rank)   # each rank's own pools
    pools = agl._init_pools(prob, g, lambda n, gen: (
        torch.randn((n, 2), generator=gen) * 1.3,
        torch.zeros(n)), 8, 20)
    epoch = make_sharded_shared_epoch(prob, cfg, 32, mesh)
    new_pools, kde, hat = epoch(_gen(50), pools, torch.tensor(1.0e6))
    mine = torch.cat([kde.X.reshape(-1), kde.bandwidth.reshape(-1),
                      hat.reshape(1)])
    both = [torch.empty_like(mine) for _ in range(WORLD)]
    dist.all_gather(both, mine)
    out["epoch.kde_same_on_ranks"] = bool(torch.equal(both[0], both[1]))
    out["epoch.hat_eps"] = float(hat)
    out["epoch.pools_finite"] = bool(torch.isfinite(new_pools.theta).all())


def _in_distribution(rank, mesh, out, tmp):
    import torch.distributed as dist
    from glabc_tpu_torch import (DiagGaussian, MixtureProblem, run_aglmcmc,
                                 run_aglmcmc_fused, run_glmcmc_nf,
                                 run_glmcmc_nf_fused, run_glmcmc_nf_pooled)

    prob, z2 = MixtureProblem(0.05), np.zeros(2)
    ip = DiagGaussian.create(2, 0.0, 0.0)
    lp = DiagGaussian.create(2, 0.0, float(np.log(0.35)))
    agl = dict(batch_size=4, alpha=0.8, hat_eps_T=0.2, num_chains=16,
               mesh=mesh, device="cpu")
    nf = dict(batch_size=4, step_size=5, train_steps=3, num_chains=16,
              n_layers=2, hidden=16, mesh=mesh, device="cpu")
    runs = {
        "aglmcmc_per_chain": lambda: run_aglmcmc(
            prob, _gen(60), 31, z2, lp, ip, global_frequency=1.0,
            step_size=10, **agl),
        "aglmcmc_shared": lambda: run_aglmcmc(
            prob, _gen(61), 31, z2, lp, ip, global_frequency=0.5,
            step_size=5, shared_adaptation=True, shared_support=32, **agl),
        "aglmcmc_fused": lambda: run_aglmcmc_fused(
            prob, _gen(62), 31, z2, ip, step_size=10, **agl),
        "aglmcmc_fused_mixed": lambda: run_aglmcmc_fused(
            prob, _gen(63), 31, z2, ip, global_frequency=0.5, step_size=5,
            shared_support=32, **agl),
        "nf_flow_is": lambda: run_glmcmc_nf(
            prob, _gen(64), 21, z2, lp, global_frequency=0.5, **nf),
        "nf_chain_states": lambda: run_glmcmc_nf(
            prob, _gen(65), 21, z2, lp, global_frequency=0.5,
            train_on="chain_states", **nf),
        "nf_pooled": lambda: run_glmcmc_nf_pooled(
            prob, _gen(66), 21, z2, lp, global_frequency=0.5,
            shared_coin=True, **nf),
        "nf_fused": lambda: run_glmcmc_nf_fused(prob, _gen(67), 16, z2,
                                                **nf),
    }
    assert tuple(runs) == IN_DISTRIBUTION
    for name, run in runs.items():
        res = run()
        out[f"{name}.shape"] = np.array(res.thetas.shape)
        out[f"{name}.finite"] = bool(np.isfinite(res.thetas).all())
        out[f"{name}.first_row"] = res.thetas[:, 0]
        c = res.counts
        out[f"{name}.steps"] = np.asarray(c.global_attempts
                                          + c.local_attempts)
        hist = getattr(res, "hat_eps_hist", None)
        if hist is not None:
            out[f"{name}.hat_eps_last"] = float(np.max(hist[-1]))
        loss = getattr(res, "loss_hist", None)
        if loss is not None:
            out[f"{name}.loss_finite"] = bool(loss.size
                                              and np.isfinite(loss).all())
            flat = torch.cat([p.detach().reshape(-1)
                              for p in res.flow.parameters()])
            both = [torch.empty_like(flat) for _ in range(WORLD)]
            dist.all_gather(both, flat)
            out[f"{name}.flow_same_on_ranks"] = bool(
                torch.equal(both[0], both[1]))
        out[f"{name}.thetas"] = res.thetas


_CHECKS = (_check_split, _exact_runs, _checkpoints, _checkpoint_manager,
           _collectives, _in_distribution)


def _worker(rank, store_path, out_dir):
    import torch.distributed as dist
    from glabc_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    initialize_distributed("gloo", store=dist.FileStore(store_path, WORLD),
                           rank=rank, world_size=WORLD)
    try:
        mesh = make_mesh(WORLD)
        out = {}
        for check in _CHECKS:
            t = time.perf_counter()
            check(rank, mesh, out, out_dir)
            out[f"seconds.{check.__name__}"] = time.perf_counter() - t
        out["jax_modules"] = sorted(
            m for m in sys.modules if m == "jax" or m.startswith(
                ("jax.", "jaxlib")) or m == "glabc_tpu"
            or m.startswith("glabc_tpu."))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results, from one 2-rank gloo group."""
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("gloo")
    ctx = mp.start_processes(_worker, args=(str(d / "store"), str(d)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"the {WORLD}-rank gloo group did not finish "
                            f"in {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


# ----------------------------------------------------------- the tests
def test_children_import_no_jax(ranks):
    for r in ranks:
        assert r["jax_modules"].size == 0, r["jax_modules"]


@pytest.mark.parametrize("name", _split_names())
def test_chain_offset_split_is_bitwise(ranks, name):
    """The plain version over C chains equals its halves launched with
    chain0 0 and C/2, each packed on its own; with chain0 0 twice the
    second half repeats the first half's streams and differs."""
    r = next(r for r in ranks if f"split.{name}" in r)
    assert bool(r[f"split.{name}"])
    assert not bool(r[f"split_control.{name}"])


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("name", EXACT)
def test_mesh_run_equals_one_device(ranks, name, rank):
    """Every rank returns the whole history and counts of the one-device
    run, bit for bit."""
    ref, got = ranks[0], ranks[rank]
    np.testing.assert_array_equal(got[f"{name}.mesh.thetas"],
                                  ref[f"{name}.ref.thetas"])
    for f in ("global_attempts", "global_accepts", "local_attempts",
              "local_accepts"):
        np.testing.assert_array_equal(got[f"{name}.mesh.counts.{f}"],
                                      ref[f"{name}.ref.counts.{f}"])


@pytest.mark.parametrize("name", ["fused", "plain"])
def test_mesh_checkpoint_resume(ranks, name):
    for r in ranks:
        np.testing.assert_array_equal(r[f"ckpt.{name}.resumed"],
                                      r[f"ckpt.{name}.tail"])
        assert bool(r[f"ckpt.{name}.own_file"])
    assert bool(ranks[0][f"ckpt.{name}.other_world_raises"])


@pytest.mark.parametrize("rank", range(WORLD))
def test_checkpoint_manager_resume_on_the_mesh(ranks, rank):
    """Each rank's K1 loop, saved and restored by ``CheckpointManager``
    under the mesh, runs on to its straight run bit for bit, from its own
    file of the shared directory."""
    r = ranks[rank]
    assert bool(r["mgr.bitwise"]) and int(r["mgr.step"]) == 1
    assert list(r["mgr.files"]) == ["ckpt_1.rank0.npz", "ckpt_1.rank1.npz"]


def test_checkpoint_manager_other_world_size_raises(ranks):
    assert bool(ranks[0]["mgr.no_mesh_raises"])
    for r in ranks:
        assert bool(r["mgr.mesh_raises"])


@pytest.mark.parametrize("qi", range(len(QS)))
def test_distributed_quantile_matches_jax(ranks, qi):
    """Against ``glabc_tpu.parallel.distributed_quantile`` under
    ``shard_map`` on a 2-device mesh, the same numpy shards: float32,
    rtol 1e-6."""
    import jax
    from jax.sharding import PartitionSpec as P

    from glabc_tpu.parallel import CHAIN_AXIS, distributed_quantile
    from glabc_tpu.parallel import make_mesh as jax_mesh

    q = QS[qi]
    fn = jax.jit(jax.shard_map(
        lambda xl: distributed_quantile(xl[0], q), mesh=jax_mesh(WORLD),
        in_specs=P(CHAIN_AXIS), out_specs=P(), check_vma=False))
    want = float(fn(_quantile_input()))
    for r in ranks:
        np.testing.assert_allclose(r["quantile"][qi], want, rtol=1e-6,
                                   atol=0)


RADIX_CASES = ("normal", "bulk_ties", "all_equal", "nan_inf", "signed_zeros",
               "one_a_rank", "split_ranks")
RESAMPLE_CASES = ("uniform", "zero_rank", "nan_negative", "one_rank")


@pytest.mark.parametrize("case", RADIX_CASES)
def test_distributed_quantile_radix_select_is_exact(ranks, case):
    """The radix select over the ranks' digit histograms equals
    ``quantile`` of the joined shards at every q of ``QS`` (0 and 1
    included), bit for bit but for the sign of a zero, NaN for NaN; no
    rank gathered a value (``gather_chains`` was unset in the children)."""
    for r in ranks:
        assert r[f"radix.{case}"].all(), r[f"radix.{case}"]


def test_split_ranks_case_splits_the_order_statistics():
    """``split_ranks``' q = 0.5 reads rank 0's largest and rank 1's
    smallest value, whose first digits (the keys' top 11 bits) differ."""
    from glabc_tpu_torch.ops.kernels.radix_select_kernel import order_keys
    from glabc_tpu_torch.samplers.aglmcmc import quantile_position

    xs = torch.from_numpy(_radix_inputs()["split_ranks"])
    lo_i, hi_i, _, _ = quantile_position(0.5, xs.numel(), "cpu")
    m = xs.shape[1]
    assert (int(lo_i), int(hi_i)) == (m - 1, m)
    lo, hi = order_keys(torch.stack([xs[0].max(), xs[1].min()]))
    assert int(lo) >> 21 != int(hi) >> 21


@pytest.mark.parametrize("case", RADIX_CASES)
def test_plain_radix_select_matches_sort(case):
    """The plain radix select at 64 random pairs of ranks equals
    ``torch.sort``'s order statistics (as keys: a zero's sign and a NaN's
    payload aside, bitwise), and the kernels' counters do not move."""
    from glabc_tpu_torch.ops.kernels.radix_select_kernel import (
        RadixSelect, order_keys, radix_select)

    x = torch.from_numpy(_radix_inputs()[case]).reshape(-1)
    xs = torch.sort(x).values
    before = RadixSelect.launches + RadixSelect.pick_launches
    rng = np.random.default_rng(9)
    for k in rng.integers(0, x.numel(), size=(64, 2)):
        k = torch.from_numpy(k)
        assert torch.equal(order_keys(radix_select(x, k)), order_keys(xs[k]))
    assert RadixSelect.launches + RadixSelect.pick_launches == before


@pytest.mark.parametrize("fault", [None, "hist", "pick"])
def test_chip_smoke_radix_checker_sees_every_pass(monkeypatch, fault):
    """``chip_smoke.radix_select_checked``, which holds K11 to its plain
    versions on the card, records one check a histogram pass and a pick,
    in order, all equal on the plain path, and catches a histogram or a
    pick that differs from its plain version."""
    from glabc_tpu_torch.ops.kernels.radix_select_kernel import (
        DIGITS, RadixSelect, order_keys)

    sys.path.insert(0, ROOT)
    import chip_smoke

    if fault == "hist":
        monkeypatch.setattr(RadixSelect, "hist", lambda kern, x, st, sh, b,
                            out: kern.plain_hist(x, st, sh, b, out).add_(
                                b == DIGITS[-1]))
    elif fault == "pick":
        def pick(kern, h, st, b, values=None):
            out = kern.plain_pick(h, st, b, values)
            return out.sub_(torch.tensor([0, 0, 0, int(b == DIGITS[0])]))
        monkeypatch.setattr(RadixSelect, "pick", pick)
    x = torch.from_numpy(_radix_inputs()["bulk_ties"]).reshape(-1)
    k = torch.tensor([3, x.numel() // 2])
    got, checks = chip_smoke.radix_select_checked(x, k)
    assert [c[:2] for c in checks] == [
        (step, b) for b in DIGITS for step in ("hist", "pick")]
    want = {None: set(), "hist": {("hist", DIGITS[-1])},
            "pick": {("pick", DIGITS[0])}}[fault]
    assert {c[:2] for c in checks if not c[2]} == want
    if fault is None:
        assert torch.equal(order_keys(got),
                           order_keys(torch.sort(x).values[k]))


def test_distributed_quantile_takes_float32_only():
    """A shard of another dtype raises before any exchange."""
    from glabc_tpu_torch.parallel import distributed_quantile

    with pytest.raises(TypeError, match="float32"):
        distributed_quantile(torch.zeros(8, dtype=torch.float64), 0.5, None)


@pytest.mark.parametrize("replicated", [False, True])
@pytest.mark.parametrize("case", RESAMPLE_CASES)
def test_rank_local_resample_equals_gathered(ranks, case, replicated):
    """Each rank's indices from its own part of the CDF equal the gathered
    CDF's (``systematic_resample`` on the joined, cleaned weights), and
    every grid point, and u = 0, has exactly one owner, whose index is the
    gathered CDF's."""
    key = f"{case}.replicated={replicated}"
    for r in ranks:
        assert bool(r[f"local_cdf.{key}"])
        assert bool(r[f"owners.{key}"])


@pytest.mark.parametrize("hat", ["1000000.0", "1.5", "0.1"])
def test_sharded_anneal_equals_one_device(ranks, hat):
    assert all(bool(r[f"anneal.{hat}"]) for r in ranks)


@pytest.mark.parametrize("replicated", [False, True])
def test_distributed_resample_equals_global(ranks, replicated):
    """The rank slices joined (or, replicated, each rank's whole grid)
    equal ``systematic_resample`` on the joined weights and the same
    u0, exactly (``tests/test_parallel.py``'s check for JAX)."""
    assert all(bool(r[f"resample.replicated={replicated}"]) for r in ranks)


def test_data_parallel_adam_step_equals_whole_batch(ranks):
    """The mean of the ranks' gradients on equal halves is the gradient
    on the whole batch: parameters within 1e-6 (the step is ~5e-4) and
    the mean loss within rtol 1e-6."""
    for r in ranks:
        loss, whole = r["adam.loss"]
        np.testing.assert_allclose(loss, whole, rtol=1e-6)
        assert float(r["adam.max_param_diff"]) <= 1e-6
        assert float(r["adam.max_param_step"]) > 1e-4


def test_shared_epoch_fits_one_kde(ranks):
    """Both ranks fit the identical KDE (all-gathered and compared) and
    anneal ε̂ off its initial 1e6."""
    for r in ranks:
        assert bool(r["epoch.kde_same_on_ranks"])
        assert bool(r["epoch.pools_finite"])
        assert float(r["epoch.hat_eps"]) < 1.0e6
    assert float(ranks[0]["epoch.hat_eps"]) == float(
        ranks[1]["epoch.hat_eps"])


@pytest.mark.parametrize("name", IN_DISTRIBUTION)
def test_adaptive_runs_under_mesh(ranks, name):
    """AGLMCMC and GLMCMC-NF under ``mesh=`` (``tests/test_parallel.py``'s
    checks): the whole history on every rank, finite, the one-device first
    row (the initial states are drawn for every chain), every step counted,
    ε̂ off 1e6, a finite loss and one flow on every rank."""
    r0, r1 = ranks
    np.testing.assert_array_equal(r0[f"{name}.thetas"], r1[f"{name}.thetas"])
    assert r0[f"{name}.shape"][0] == 16
    assert bool(r0[f"{name}.finite"])
    assert np.all(r0[f"{name}.first_row"] == 0.0)
    assert np.all(r0[f"{name}.steps"] == r0[f"{name}.shape"][1] - 1)
    if f"{name}.hat_eps_last" in r0:
        assert float(r0[f"{name}.hat_eps_last"]) < 1.0e6
    if f"{name}.loss_finite" in r0:
        assert bool(r0[f"{name}.loss_finite"])
        assert bool(r0[f"{name}.flow_same_on_ranks"])
        assert bool(r1[f"{name}.flow_same_on_ranks"])


def _entry_points():
    import glabc_tpu_torch as gt
    from glabc_tpu_torch import DiagGaussian, MixtureProblem

    prob, z2 = MixtureProblem(0.05), np.zeros(2)
    ip = DiagGaussian.create(2, 0.0, 0.0)
    a = (prob, _gen(0), 5, z2)
    kw = lambda m: dict(mesh=m, device="cpu")
    prog = lambda: gt.mixture_tile_program(prob)
    return {
        "run_glmcmc": lambda m: gt.run_glmcmc(*a, ip, ip, **kw(m)),
        "run_global_mcmc": lambda m: gt.run_global_mcmc(*a, ip, ip, **kw(m)),
        "run_glmcmc_fused": lambda m: gt.run_glmcmc_fused(*a, **kw(m)),
        "run_global_mcmc_fused": lambda m: gt.run_global_mcmc_fused(
            *a, **kw(m)),
        "run_glmala": lambda m: gt.run_glmala(*a, ip, **kw(m)),
        "run_glmala_fused": lambda m: gt.run_glmala_fused(*a, **kw(m)),
        "run_fused_program": lambda m: gt.run_fused_program(
            prob, prog(), _gen(0), 5, z2, **kw(m)),
        "run_glmala_program": lambda m: gt.run_glmala_program(
            prob, prog(), _gen(0), 5, z2, **kw(m)),
        "run_aglmcmc": lambda m: gt.run_aglmcmc(*a, ip, ip, **kw(m)),
        "run_aglmcmc_fused": lambda m: gt.run_aglmcmc_fused(*a, ip, **kw(m)),
        "run_aglmcmc_fused_mixed": lambda m: gt.run_aglmcmc_fused_mixed(
            *a, ip, global_frequency=0.5, **kw(m)),
        "run_glmcmc_nf": lambda m: gt.run_glmcmc_nf(*a, ip, **kw(m)),
        "run_glmcmc_nf_pooled": lambda m: gt.run_glmcmc_nf_pooled(
            *a, ip, **kw(m)),
        "run_glmcmc_nf_fused": lambda m: gt.run_glmcmc_nf_fused(*a, **kw(m)),
    }


ENTRY_POINTS = ("run_glmcmc", "run_global_mcmc", "run_glmcmc_fused",
                "run_global_mcmc_fused", "run_glmala", "run_glmala_fused",
                "run_fused_program", "run_glmala_program", "run_aglmcmc",
                "run_aglmcmc_fused", "run_aglmcmc_fused_mixed",
                "run_glmcmc_nf", "run_glmcmc_nf_pooled",
                "run_glmcmc_nf_fused")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_refuses_a_mesh_of_another_kind(name):
    """Every entry point that takes ``mesh=`` raises ``TypeError`` for
    anything but a 1-D ``DeviceMesh``, before it draws or runs."""
    run = _entry_points()[name]
    assert tuple(_entry_points()) == ENTRY_POINTS
    with pytest.raises(TypeError, match="DeviceMesh"):
        run(object())
