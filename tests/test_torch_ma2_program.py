"""MA(2) through the generic fused kernel's driver held against the
benchmark's plain reference, on the CPU.

* ``run_fused_program`` (K8's plain version) on MA(2) at num_draws = 100,
  32 chains x 33 states, against ``perfbench/reference/ma2.py``'s replay
  on the same Philox streams: final theta, dataset and log-kernel within
  1e-5 max(1, |x|) and the three counters equal, for every chain.
* A fault planted in the reference (theta_2's term left out of the
  recursion, or the local move of one step skipped) is caught.
* At ``collect_history=False`` both program drivers return every chain's
  final state: ``thetas[:, -1]`` is ``final_carry[0].T`` and the last row
  of the history of the same run with ``collect_history=True``.
* A traced run records the call's ``glabc.run.*`` span and its
  ``glabc.io.h2d`` / ``glabc.io.d2h`` copies with the bytes worked out from
  the shapes.
"""

import numpy as np
import pytest
import torch

import perfbench.reference.ma2 as ref
from glabc_tpu_torch import MA2Problem, run_fused_program, run_glmala_program
from glabc_tpu_torch.utils.profiling import trace
from perfbench.harness.compare import mismatch_share

C, N_ITE, T_CALL = 32, 33, 16
KSEED, YSEED = 2**33 + 17, 3000000007
B, GF, LP = 5, 0.8, 0.1
Y_OBS = (1.0865206718444824, 0.4801788032054901, -0.01683427393436432)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def _y0(pb, chains):
    """Each chain's dataset from the reference simulator at theta = 0."""
    th = torch.zeros(chains, 2)
    return ref.simulate(pb, YSEED, torch.arange(chains), 0, th)


@pytest.fixture(scope="module")
def run():
    """The port's run and the inputs the reference replays it from."""
    prob = MA2Problem()
    pb = ref.Problem.create(prob.num_draws, Y_OBS, prob.epsilon)
    y0 = _y0(pb, C)
    res = run_fused_program(prob, prob.tile_program(lp_scale=LP), gen(0),
                            N_ITE, np.zeros(2), y0=y0.numpy(),
                            global_frequency=GF, batch_size=B, num_chains=C,
                            steps_per_call=T_CALL, collect_history=False,
                            seed=KSEED, device="cpu")
    return pb, y0, res


def _replay(pb, y0):
    mv = ref.Moves.create(pb, B, GF, LP)
    return ref.replay(pb, mv, torch.full((C,), KSEED), torch.arange(C),
                      torch.zeros(C, 2), y0, N_ITE - 1)


def _mismatch(res, want) -> float:
    """The share of chains whose final (theta, y, log K) or counters
    differ from the reference's."""
    th, y, lk = res.final_carry
    got = torch.cat([torch.from_numpy(res.thetas[:, -1]), y.T, lk[:, None]],
                    dim=1)
    w_th, w_y, w_lk, w_c = want
    c = res.counts
    got_c = [torch.from_numpy(x) for x in (c.global_attempts,
                                           c.global_accepts,
                                           c.local_accepts)]
    return mismatch_share(got, got_c, torch.cat([w_th, w_y, w_lk[:, None]],
                                                dim=1), w_c)


def test_fused_program_matches_the_reference(run):
    pb, y0, res = run
    want = _replay(pb, y0)
    assert _mismatch(res, want) == 0.0
    c = res.counts
    # both moves were taken and both accepted somewhere
    assert c.global_accepts.sum() > 0 and c.local_accepts.sum() > 0
    assert np.all(c.global_attempts + c.local_attempts == N_ITE - 1)
    assert bool(ref.inside(torch.from_numpy(res.thetas[:, -1])).all())


def _theta2_left_out(summaries):
    def faulty(pb, theta, e):
        return summaries(pb, theta * torch.tensor([1.0, 0.0]), e)
    return faulty


def _one_local_move_skipped(transition):
    """The local moves of the first step that accepts one are dropped."""
    done = []

    def faulty(pb, mv, state, noise):
        new, (is_g, g_acc, l_acc) = transition(pb, mv, state, noise)
        if not done and bool(l_acc.any()):
            done.append(True)
            keep = lambda n, o: torch.where(
                is_g.reshape(-1, *[1] * (n.dim() - 1)), n, o)
            new = tuple(keep(n, o) for n, o in zip(new, state))
            l_acc = torch.zeros_like(l_acc)
        return new, (is_g, g_acc, l_acc)
    return faulty


@pytest.mark.parametrize("fault", ["theta2_left_out", "local_move_skipped"])
def test_a_fault_in_the_reference_is_caught(run, monkeypatch, fault):
    pb, y0, res = run
    if fault == "theta2_left_out":
        monkeypatch.setattr(ref, "summaries", _theta2_left_out(ref.summaries))
    else:
        monkeypatch.setattr(ref, "transition",
                            _one_local_move_skipped(ref.transition))
    assert _mismatch(res, _replay(pb, y0)) > 0.0


# ------------------------------------------ collect_history=False: finals
def _small():
    prob = MA2Problem(num_draws=16, y_obs=Y_OBS)
    return prob, prob.tile_program(lp_scale=LP)


def _driver(name, collect_history, y0=None):
    prob, prog = _small()
    kw = dict(y0=y0, num_chains=16, steps_per_call=4,
              collect_history=collect_history, device="cpu")
    if name == "fused_program":
        return run_fused_program(prob, prog, gen(5), 13, np.zeros(2),
                                 global_frequency=GF, seed=21, **kw)
    return run_glmala_program(prob, prog, gen(5), 13, np.zeros(2),
                              num_grad=4, tau=0.1, seed=21, **kw)


@pytest.mark.parametrize("name", ["fused_program", "glmala_program"])
def test_no_history_returns_the_final_states(name):
    off, on = _driver(name, False), _driver(name, True)
    assert off.thetas.shape == (16, 1, 2) and on.thetas.shape == (16, 13, 2)
    np.testing.assert_array_equal(off.thetas[:, -1],
                                  off.final_carry[0].T.numpy())
    np.testing.assert_array_equal(off.thetas[:, -1], on.thetas[:, -1])
    assert not np.array_equal(off.thetas[:, -1], on.thetas[:, 0])
    for x, y in zip(off.counts, on.counts):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("collect_history", [False, True])
@pytest.mark.parametrize("name", ["fused_program", "glmala_program"])
def test_traced_run_spans_and_bytes(tmp_path, name, collect_history):
    y0 = np.random.default_rng(1).normal(size=(16, 3)).astype(np.float32)
    with trace(str(tmp_path / "tr")) as prof:
        _driver(name, collect_history, y0)
    recs = prof.spans
    runs = [i for i, r in enumerate(recs) if r.name == f"glabc.run.{name}"]
    assert len(runs) == 1 and recs[runs[0]].parent is None
    f32, f64, d = 4, 8, 2
    h2d = [r for r in recs if r.name == "glabc.io.h2d"]
    d2h = [r for r in recs if r.name == "glabc.io.d2h"]
    assert [r.nbytes for r in h2d] == [d * f32 + y0.nbytes]   # theta0, y0
    # one row of states (the first with the history, else the last), the
    # history's blocks (12 steps in launches of 4) and three float64
    # counters
    blocks = [16 * 4 * d * f32] * 3 if collect_history else []
    assert sorted(r.nbytes for r in d2h) == sorted([16 * d * f32] + blocks
                                                   + [16 * f64] * 3)
    assert all(r.parent == runs[0] for r in h2d + d2h)
