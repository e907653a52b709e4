"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped (a CPU dry run) and the rest of a run
is driven with a fault planted in the program where it produces its
answers: a step that returns its state unchanged, half of the chains left
out, an answer altered, and on several chips the exchange between them
left out."""

import multiprocessing as mp

import pytest
import torch

from perfbench.harness.bench import resolve
from perfbench.harness.main import parse, run_rank


def _run(workload, seed=123457):
    opts = parse(["--workload", workload, "--seed", str(seed), "--seconds",
                  "1", "--trace", "0", "--cpu-dry-run"])
    return run_rank(opts, resolve(workload), 0, 1, None, 0.0)


def k1_fault(kind):
    from glabc_tpu_torch.ops.kernels.packed_kernel import PackedMixtureGLMCMC

    run = PackedMixtureGLMCMC.run

    def faulty(self, seed, theta, y, logk, *, step0=0, chain0=0):
        th, yy, lk, hist, stats = run(self, seed, theta, y, logk,
                                      step0=step0, chain0=chain0)
        if kind == "unchanged":
            zero = type(stats)(*(torch.zeros_like(s) for s in stats))
            return theta, y, logk, hist, zero
        if kind == "half":
            h = theta.shape[1] // 2
            th, yy, lk = th.clone(), yy.clone(), lk.clone()
            th[:, h:], yy[:, h:], lk[:, h:] = (theta[:, h:], y[:, h:],
                                               logk[:, h:])
            return th, yy, lk, hist, stats
        return th + 1e-3, yy, lk, hist, stats         # altered

    return faulty


def k5_fault(kind):
    from glabc_tpu_torch.ops.kernels.pool_isir_mixed_kernel import \
        PoolISIRMixed

    run = PoolISIRMixed.run

    def faulty(self, seed, res, ptheta, px, plogw, plogk, theta, y, logk, *,
               step0=0, chain0=0):
        out = run(self, seed, res, ptheta, px, plogw, plogk, theta, y, logk,
                  step0=step0, chain0=chain0)
        th, yy, lk, ga, gacc, lacc, hist = out
        if kind == "unchanged":
            z = torch.zeros_like(ga)
            return theta, y, logk, z, z, z, hist
        if kind == "half":
            h = theta.shape[1] // 2
            th, yy, lk = th.clone(), yy.clone(), lk.clone()
            th[:, h:], yy[:, h:], lk[h:] = theta[:, h:], y[:, h:], logk[h:]
            return th, yy, lk, ga, gacc, lacc, hist
        return th + 1e-3, yy, lk, ga, gacc, lacc, hist

    return faulty


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_k1_fault_is_not_correct(monkeypatch, kind):
    from glabc_tpu_torch.ops.kernels.packed_kernel import PackedMixtureGLMCMC

    monkeypatch.setattr(PackedMixtureGLMCMC, "run", k1_fault(kind))
    out = _run("glmcmc-final")
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_k5_fault_is_not_correct(monkeypatch, kind):
    from glabc_tpu_torch.ops.kernels.pool_isir_mixed_kernel import \
        PoolISIRMixed

    monkeypatch.setattr(PoolISIRMixed, "run", k5_fault(kind))
    out = _run("aglmcmc-shared")
    assert out["correct"] is False, out["checks"]


def test_sound_runs_are_correct():
    for w in ("glmcmc-final", "aglmcmc-shared"):
        assert _run(w)["correct"] is True


def _mesh_rank(rank, world, port, exchange, queue):
    """One rank of the four-chip cell on the CPU (gloo); ``exchange=False``
    leaves the quantile's exchange between ranks out."""
    import glabc_tpu_torch.parallel.sharded as sharded
    from torch.distributed import TCPStore

    if not exchange:
        from glabc_tpu_torch.samplers.aglmcmc import quantile

        sharded.distributed_quantile = \
            lambda x_local, q, mesh: quantile(x_local.reshape(-1), q)
    torch.set_num_threads(1)
    opts = parse(["--workload", "aglmcmc-shared-mesh4", "--seed", "77",
                  "--seconds", "1", "--trace", "0", "--cpu-dry-run"])
    store = TCPStore("127.0.0.1", port, world, is_master=False)
    out = run_rank(opts, resolve("aglmcmc-shared-mesh4"), rank, world, store,
                   0.0)
    if rank == 0:
        queue.put((out["correct"], out["checks"]))


@pytest.mark.parametrize("exchange", [True, False])
def test_mesh_exchange_left_out_is_not_correct(exchange):
    from torch.distributed import TCPStore

    world = 4
    store = TCPStore("127.0.0.1", 0, world + 1, is_master=True,
                     wait_for_workers=False)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_mesh_rank,
                         args=(r, world, store.port, exchange, q))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        correct, checks = q.get(timeout=600)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
    assert all(not p.is_alive() for p in procs)
    assert correct is exchange, checks
