"""The port's spans and byte counters (``glabc_tpu_torch.utils.profiling``),
on the CPU.

* ``annotate`` with no profiler recording keeps no record, and works as a
  decorator; under a profiler it records name, enclosing span and bytes.
* Under ``trace()``, ``run_glmcmc_fused`` records one
  ``glabc.run.glmcmc_fused`` span whose ``glabc.io.*`` bytes are those of
  the arrays it moves, worked out from the shapes.
* ``run_aglmcmc_fused_mixed`` records, per shared epoch, one anneal and
  one support span, then ``C / redraw_chunk`` of redraw and density in
  that order under ``glabc.epoch`` (the Mixture problem's pools come from
  K10 and K4's pool epilogue; each redraw span counts the bytes of the
  pool rows K10 wrote), then one ``glabc.epoch.pool`` for the driver's
  repack after the epoch: the four phases of ``adapt.*_ms`` all recorded.
* The shared epoch's chunks (``_redraw_chunks``): for the Mixture
  problem each ``glabc.epoch.redraw`` counts the bytes of the pool rows
  K10 wrote and is followed by one density span; MA(2), a problem that
  overrides its simulator and d past K4's widest keep the generic path,
  whose redraw spans count 0 bytes, each followed by density and pool.
* In a 2-rank gloo group, ``glabc.mesh.gather`` counts world times the
  local bytes and ``glabc.mesh.all_sum`` the reduced bytes; a sharded run's
  collectives add up, epoch by epoch, to the gathers of every rank's pool
  discrepancies (float32) and weights (float64) and the support's sum.
* Both drivers return bitwise the same with a profiler on and off: the
  spans draw no random numbers and reorder nothing.
"""

import os
import time

import numpy as np
import pytest
import torch

from glabc_tpu_torch import (DiagGaussian, HighDimMixtureProblem,
                             MA2Problem, MixtureProblem)
from glabc_tpu_torch.samplers.aglmcmc_fused import run_aglmcmc_fused_mixed
from glabc_tpu_torch.samplers.glmcmc_fused import run_glmcmc_fused
from glabc_tpu_torch.utils import profiling
from glabc_tpu_torch.utils.profiling import annotate, trace

WORLD = 2
JOIN_TIMEOUT_S = 300
PROB = MixtureProblem(0.05)
IP = DiagGaussian.create(2, 0.0, 0.0)
C, D = 64, 2
# AGLMCMC: seg_len = 10 steps, 3 segments, 2 epochs, 4 redraw chunks
AGL = dict(global_frequency=0.5, batch_size=4, step_size=5, alpha=0.8,
           hat_eps_T=0.2, shared_support=32, redraw_chunk=4,
           collect_history=False, device="cpu")
AGL_ITE, AGL_C, AGL_EPOCHS = 31, 16, 2


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _glmcmc(collect_history, y0=None):
    return run_glmcmc_fused(PROB, _gen(3), 65, np.zeros(D), y0=y0,
                            num_chains=C, steps_per_call=32,
                            block_chains=32, collect_history=collect_history,
                            seed=11, kernel="packed", device="cpu")


def _aglmcmc(**kw):
    return run_aglmcmc_fused_mixed(PROB, _gen(4), AGL_ITE, np.zeros(D), IP,
                                   num_chains=AGL_C, seed=12,
                                   **{**AGL, **kw})


def _traced(tmp_path, fn):
    with trace(str(tmp_path / "tr")) as prof:
        out = fn()
    return out, prof.spans


# ------------------------------------------------------------- annotate
def test_annotate_records_nothing_without_a_profiler():
    profiling.reset()

    @annotate("glabc.test.decorated", 8)
    def work(x):
        with annotate("glabc.test.inner", 4):
            return x * 2

    assert torch.equal(work(torch.ones(3)), torch.full((3,), 2.0))
    assert work.__name__ == "work"
    assert profiling.spans() == []


def test_annotate_records_names_parents_and_bytes_under_a_profiler():
    profiling.reset()

    @annotate("glabc.test.decorated")
    def work(x):
        with annotate("glabc.test.inner", 4):
            return x * 2

    with torch.profiler.profile():
        with annotate("glabc.test.outer", 16):
            work(torch.ones(3))
            work(torch.ones(3))
    recs = profiling.spans()
    profiling.reset()
    assert [(r.name, r.parent, r.nbytes) for r in recs] == [
        ("glabc.test.outer", None, 16), ("glabc.test.decorated", 0, 0),
        ("glabc.test.inner", 1, 4), ("glabc.test.decorated", 0, 0),
        ("glabc.test.inner", 3, 4)]
    assert all(r.device_ms >= 0 and r.host_ms >= 0 for r in recs)
    assert recs[0].host_ms >= recs[1].host_ms + recs[3].host_ms
    assert profiling.spans() == []


def test_trace_resets_the_store_and_leaves_the_block_spans(tmp_path):
    with torch.profiler.profile():
        with annotate("glabc.test.before"):
            pass
    with trace(str(tmp_path / "tr")) as prof:
        with annotate("glabc.test.inside", 2):
            pass
    assert [(r.name, r.nbytes) for r in prof.spans] == [
        ("glabc.test.inside", 2)]


# --------------------------------------------------------- fused GLMCMC
@pytest.mark.parametrize("collect_history", [False, True])
@pytest.mark.parametrize("with_y0", [False, True])
def test_glmcmc_fused_io_bytes_from_the_shapes(tmp_path, collect_history,
                                               with_y0):
    y0 = (np.random.default_rng(0).normal(size=(C, D)).astype(np.float32)
          if with_y0 else None)
    res, recs = _traced(tmp_path, lambda: _glmcmc(collect_history, y0))
    runs = [i for i, r in enumerate(recs)
            if r.name == "glabc.run.glmcmc_fused"]
    assert len(runs) == 1 and recs[runs[0]].parent is None
    f32, f64 = 4, 8
    up = D * f32 + (C * D * f32 if with_y0 else 0)       # theta0, y0
    states = res.thetas.shape[1]                          # to the host
    assert states == (65 if collect_history else 1)
    down = C * states * D * f32 + 3 * C * f64             # + 3 counters
    h2d = [r for r in recs if r.name == "glabc.io.h2d"]
    d2h = [r for r in recs if r.name == "glabc.io.d2h"]
    assert [r.nbytes for r in h2d] == [up]
    assert sum(r.nbytes for r in d2h) == down
    assert len(d2h) == 3 + (1 + 2 if collect_history else 1)
    assert all(r.parent == runs[0] for r in h2d + d2h)


# -------------------------------------------------------- fused AGLMCMC
def test_aglmcmc_mixed_epoch_phases_in_order(tmp_path):
    _, recs = _traced(tmp_path, _aglmcmc)
    names = [r.name for r in recs]
    (run,) = [i for i, n in enumerate(names)
              if n == "glabc.run.aglmcmc_fused_mixed"]
    epochs = [i for i, n in enumerate(names) if n == "glabc.epoch"]
    assert len(epochs) == AGL_EPOCHS
    chunks = AGL_C // AGL["redraw_chunk"]
    want = (["glabc.epoch.anneal", "glabc.epoch.support"]
            + ["glabc.epoch.redraw", "glabc.epoch.density"] * chunks)
    seg_len = round(AGL["step_size"] / AGL["global_frequency"])
    rows = AGL["redraw_chunk"] * seg_len * AGL["batch_size"]
    for e in epochs:
        assert recs[e].parent == run
        inside = [i for i, r in enumerate(recs) if r.parent == e]
        assert [names[i] for i in inside] == want
        # theta, x, dis and prior + log K of each row, float32
        assert [recs[i].nbytes for i in inside
                if names[i] == "glabc.epoch.redraw"] == \
            [rows * (2 * D + 2) * 4] * chunks
        after = [i for i, r in enumerate(recs)
                 if r.parent == run and i > inside[-1]
                 and names[i].startswith("glabc.epoch")]
        assert names[after[0]] == "glabc.epoch.pool"
    repacks = [r for r in recs if r.name == "glabc.epoch.pool"
               and r.parent == run]
    assert len(repacks) == AGL_EPOCHS
    assert {n for n in names if n.startswith("glabc.epoch.")} == {
        f"glabc.epoch.{p}" for p in ("anneal", "support", "redraw",
                                     "density", "pool")}
    # the per-epoch threshold's copy to the host, beside the run's own
    d2h = [r for r in recs if r.name == "glabc.io.d2h"]
    assert sum(r.parent == run for r in d2h) == len(d2h)
    assert sum(r.nbytes == 4 for r in d2h) >= AGL_EPOCHS


class _OwnSimulator(MixtureProblem):
    def simulate(self, theta, generator=None):
        return super().simulate(theta, generator)


@pytest.mark.parametrize("problem", [
    MixtureProblem(0.05), MA2Problem(), _OwnSimulator(0.05),
    HighDimMixtureProblem(130)], ids=["mixture", "ma2", "own", "d130"])
def test_redraw_span_bytes_show_the_path(problem, tmp_path):
    from glabc_tpu_torch.models.kde import KernelDensity
    from glabc_tpu_torch.samplers import aglmcmc as agl

    d, chains, rows, chunk = problem.theta_dim, 8, 30, 4
    cfg = agl.AGLMCMCConfig(0.5, 5, 6, 0.8, 0.2, 4, 0, 0)
    # a KDE inside each prior's support (MA(2): the triangle)
    kde = KernelDensity(torch.full((1, d), 0.2), torch.ones(1),
                        torch.full((d,), 0.1))
    with trace(str(tmp_path / "tr")) as prof:
        pools = agl._redraw_chunks(problem, cfg, _gen(3), kde, chains, rows,
                                   chunk)
    spans = [s for s in prof.spans if s.name.startswith("glabc.epoch.")]
    takes = type(problem) is MixtureProblem
    assert (agl._redraw_inputs(problem, kde) is not None) == takes
    phases = ["redraw", "density"] + ([] if takes else ["pool"])
    assert [s.name for s in spans] == \
        [f"glabc.epoch.{p}" for p in phases] * (chains // chunk)
    # theta, x, dis and prior + log K of each row K10 wrote, float32
    want = chunk * rows * (2 * d + 2) * 4 if takes else 0
    assert [s.nbytes for s in spans if s.name == "glabc.epoch.redraw"] == \
        [want] * (chains // chunk)
    assert pools.theta.shape == (chains, rows, d)
    assert bool(torch.isfinite(pools.theta).all())


# ------------------------------------------------ spans change nothing
def test_glmcmc_fused_same_bits_traced_and_not(tmp_path):
    plain = _glmcmc(True)
    traced, _ = _traced(tmp_path, lambda: _glmcmc(True))
    assert np.array_equal(plain.thetas, traced.thetas)
    for f in plain.counts._fields:
        assert np.array_equal(getattr(plain.counts, f),
                              getattr(traced.counts, f))


def test_aglmcmc_mixed_same_bits_traced_and_not(tmp_path):
    plain = _aglmcmc(collect_history=True)
    traced, _ = _traced(tmp_path, lambda: _aglmcmc(collect_history=True))
    assert np.array_equal(plain.thetas, traced.thetas)
    assert np.array_equal(plain.hat_eps, traced.hat_eps)
    assert np.array_equal(plain.hat_eps_hist, traced.hat_eps_hist)
    for f in plain.counts._fields:
        assert np.array_equal(getattr(plain.counts, f),
                              getattr(traced.counts, f))


# ------------------------------------------- collectives in a gloo group
def _worker(rank, store_path, out_dir):
    import torch.distributed as dist
    from glabc_tpu_torch.parallel import initialize_distributed, make_mesh
    from glabc_tpu_torch.parallel.mesh import gather_chains
    from glabc_tpu_torch.parallel.sharded import _all_sum

    torch.set_num_threads(1)
    initialize_distributed("gloo", store=dist.FileStore(store_path, WORLD),
                           rank=rank, world_size=WORLD)
    try:
        mesh = make_mesh(WORLD)
        out = {}
        x = torch.arange(12, dtype=torch.float64).reshape(6, 2) + rank
        profiling.reset()
        with torch.profiler.profile():
            gathered = gather_chains(x, mesh)
            _all_sum(x[0], mesh)
        out["local_bytes"] = x.numel() * x.element_size()
        out["gathered_bytes"] = gathered.numel() * gathered.element_size()
        recs = profiling.spans()
        out["names"] = np.array([r.name for r in recs])
        out["nbytes"] = np.array([r.nbytes for r in recs])

        profiling.reset()
        with torch.profiler.profile():
            _aglmcmc(mesh=mesh)
        recs = profiling.spans()
        names = [r.name for r in recs]
        epochs = [i for i, n in enumerate(names) if n == "glabc.epoch"]
        run = names.index("glabc.run.aglmcmc_fused_mixed")

        def inside(i, top):        # whether span i runs inside span top
            while i is not None and i != top:
                i = recs[i].parent
            return i == top

        out["epoch_mesh_bytes"] = np.array(
            [sum(r.nbytes for i, r in enumerate(recs)
                 if r.name.startswith("glabc.mesh.") and inside(i, e))
             for e in epochs])
        out["run_mesh_bytes"] = sum(
            r.nbytes for i, r in enumerate(recs)
            if r.name.startswith("glabc.mesh.") and inside(i, run))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's span records, from one 2-rank gloo group."""
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


@pytest.mark.parametrize("rank", range(WORLD))
def test_mesh_gather_counts_world_times_local_bytes(ranks, rank):
    r = ranks[rank]
    assert list(r["names"]) == ["glabc.mesh.gather", "glabc.mesh.all_sum"]
    gather, all_sum = (int(b) for b in r["nbytes"])
    assert gather == int(r["gathered_bytes"]) == WORLD * int(r["local_bytes"])
    assert all_sum == 2 * 8


@pytest.mark.parametrize("rank", range(WORLD))
def test_mesh_epoch_collective_bytes_reckoned(ranks, rank):
    from glabc_tpu_torch.ops.kernels.radix_select_kernel import DIGITS

    r = ranks[rank]
    # the anneal's count (int64) and its radix select's two int64
    # histograms a pass; the resample's weight totals (float64, one a
    # rank) and support indices (int64); the support's sum (float32).  No
    # pool row is exchanged.
    want = (8 + sum(2 * 8 * (1 << b) for b in DIGITS) + WORLD * 8
            + AGL["shared_support"] * 8 + AGL["shared_support"] * D * 4)
    assert list(r["epoch_mesh_bytes"]) == [want] * AGL_EPOCHS
    # the run's end: every chain's final state (float32) and three
    # counters (float64) gathered over the ranks
    assert int(r["run_mesh_bytes"]) == (AGL_EPOCHS * want + AGL_C * D * 4
                                        + 3 * AGL_C * 8)
