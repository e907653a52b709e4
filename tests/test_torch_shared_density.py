"""The shared AGLMCMC epoch's pool density through K4, on the CPU.

The shared epoch computes each redraw chunk's ``log q`` as one K4 call (its
plain version for CPU tensors): the shared KDE as one chain (C = 1), the
chunk's draws as its points.  Held here:

* at d = 2 and 40 (K4's static and runtime-d shapes on the card) the new
  pools' ``log_q`` is ``KernelDensity.log_prob`` of the same draws within
  K4's 1e-4 max(1, |log q|); at d = 130, past K4's widest d, it is
  ``KernelDensity.log_prob`` to the bit and K4 is not called;
* one K4 call a redraw chunk, each over ``chunk x pool rows`` points, and
  ``redraw_chunk`` 0 and a divisor give the same ``log_q`` of the same
  draws;
* K4's plain version at C = 1 past ``_PLAIN_CHUNK`` elements works in
  blocks of points and gives the unblocked answer;
* ``chip_smoke.shared_k4``, the exact launch count the card's smoke run
  expects of a shared-adaptation run, counts the K4 calls of the fused
  mixed driver and of the plain path, and their K10 calls (the Mixture
  problem's chunks take K10, ``test_torch_shared_redraw.py``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import glabc_tpu_torch.ops.kernels.kde_logprob_kernel as k4
from glabc_tpu_torch import DiagGaussian, HighDimMixtureProblem, MixtureProblem
from glabc_tpu_torch.models.kde import KernelDensity
from glabc_tpu_torch.ops.kernels import BatchedMixtureLogProb, SharedRedraw
from glabc_tpu_torch.samplers import aglmcmc as agl
from glabc_tpu_torch.samplers import run_aglmcmc, run_aglmcmc_fused_mixed

C, P, SUPPORT = 8, 30, 64
CFG = agl.AGLMCMCConfig(0.5, 5, 6, 0.8, 0.2, 4, 0, 0)


def _problem(d):
    return MixtureProblem(0.05) if d == 2 else HighDimMixtureProblem(d)


def _pools(d, seed=0):
    ip = DiagGaussian.create(d, 0.0, 0.0)
    gen = torch.Generator().manual_seed(seed)
    return agl._init_pools(_problem(d), gen, ip, C, P)


def _epoch(d, redraw_chunk, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return agl._shared_epoch_update(_problem(d), CFG, SUPPORT, gen,
                                    _pools(d), torch.tensor(1e6),
                                    redraw_chunk)


@pytest.fixture
def k4_calls(monkeypatch):
    """The shapes of the points of every K4 call (``run``), in order."""
    calls = []
    orig = BatchedMixtureLogProb.run

    def run(self, x, *args, **kw):
        calls.append(tuple(x.shape))
        return orig(self, x, *args, **kw)

    monkeypatch.setattr(BatchedMixtureLogProb, "run", run)
    return calls


@pytest.fixture
def k10_calls(monkeypatch):
    """One entry for every K10 call (``SharedRedraw.run``)."""
    calls = []
    orig = SharedRedraw.run

    def run(self, *args, **kw):
        calls.append(1)
        return orig(self, *args, **kw)

    monkeypatch.setattr(SharedRedraw, "run", run)
    return calls


@pytest.mark.parametrize("d", [2, 40])
def test_shared_log_q_is_the_kde_density(d, k4_calls):
    pools, kde, _ = _epoch(d, redraw_chunk=2)
    assert k4_calls == [(1, 2 * P, d)] * (C // 2)
    want = kde.log_prob(pools.theta)
    rel = (pools.log_q - want).abs() / want.abs().clamp_min(1.0)
    assert torch.isfinite(pools.log_q).all()
    assert float(rel.max()) <= 1e-4


def test_shared_log_q_past_k4_width_is_kernel_density(k4_calls):
    d = k4._MAX_D + 2
    pools, kde, _ = _epoch(d, redraw_chunk=0)
    assert k4_calls == []
    assert torch.equal(pools.log_q, kde.log_prob(pools.theta))


@pytest.mark.parametrize("d", [2, 40])
def test_redraw_chunk_keeps_log_q(d, monkeypatch, k4_calls):
    """The same draws (``_redraw`` replaced by slices of one tensor, taken
    in order) give the same ``log_q`` in one chunk and in four, on the
    generic chunk path (these problems take K10's otherwise,
    ``test_torch_shared_redraw.py``)."""
    monkeypatch.setattr(agl, "_redraw_inputs", lambda *a: None)
    draws = torch.randn((C, P, d), generator=torch.Generator().manual_seed(3))

    def run(redraw_chunk):
        taken = [0]

        def redraw(problem, cfg, generator, kde, num_rows, batch=()):
            lo = taken[0]
            taken[0] += batch[0]
            return draws[lo:taken[0]]

        monkeypatch.setattr(agl, "_redraw", redraw)
        pools, _, _ = _epoch(d, redraw_chunk)
        assert taken[0] == C and torch.equal(pools.theta, draws)
        return pools.log_q

    whole = run(0)
    assert k4_calls == [(1, C * P, d)]
    assert torch.equal(run(2), whole)
    assert k4_calls[1:] == [(1, 2 * P, d)] * (C // 2)


@pytest.mark.parametrize("Cb,N,Pk", [(1, 777, 50), (3, 100, 37)])
def test_plain_blocks_of_points_match_unblocked(monkeypatch, Cb, N, Pk):
    g = torch.Generator().manual_seed(N)
    kdes = KernelDensity.fit(torch.randn((Cb, Pk, 3), generator=g),
                             torch.rand((Cb, Pk), generator=g))
    x = torch.randn((Cb, N, 3), generator=g) * 1.5
    args = (x, *k4.kde_logprob_inputs(kdes))
    whole = BatchedMixtureLogProb().plain(*args)
    monkeypatch.setattr(k4, "_PLAIN_CHUNK", 1000)      # 20 or 27 points
    assert N * Pk > 1000
    blocked = BatchedMixtureLogProb().plain(*args)
    assert torch.equal(blocked, whole)
    lp = kdes.log_prob(x)
    assert float(((blocked - lp).abs() / lp.abs().clamp_min(1.0)).max()) \
        <= 1e-4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("method", ["fused", "scan"])
@pytest.mark.parametrize("redraw_chunk", [0, 16, 64])
def test_chip_smoke_counts_shared_k4_calls(method, redraw_chunk, k4_calls,
                                           k10_calls):
    """64 chains, gf 0.5, step 10: segments of 20 steps, 71 states give 4
    segments (the last of 10) and 3 epochs."""
    chains, steps = 64, 70
    gen = torch.Generator().manual_seed(5)
    ip = DiagGaussian.create(2, 0.0, 0.0)
    if method == "fused":
        run_aglmcmc_fused_mixed(
            MixtureProblem(0.05), gen, steps + 1, np.zeros(2), ip,
            global_frequency=0.5, step_size=10, num_chains=chains,
            shared_support=64, redraw_chunk=redraw_chunk, device="cpu")
    else:
        run_aglmcmc(MixtureProblem(0.05), gen, steps + 1, np.zeros(2),
                    DiagGaussian.create(2, 0.0, float(np.log(0.35))), ip,
                    0.5, 5, 10, num_chains=chains, shared_adaptation=True,
                    shared_support=64, redraw_chunk=redraw_chunk,
                    device="cpu")
    want = _chip_smoke().shared_k4(chains, steps, redraw_chunk, seg=20)
    assert want == 3 * (chains // redraw_chunk if redraw_chunk < chains
                        and redraw_chunk else 1)
    assert len(k4_calls) == want
    assert len(k10_calls) == want
