"""The fused drivers' shared run skeleton (``samplers/_fused_io.FusedRun``),
on the CPU.

* At ``collect_history=False`` every fused driver returns every chain's
  final state: ``thetas`` is ``(C, 1, d)``, equal to the final carry's
  theta and to the last row of the history of the same run with
  ``collect_history=True``, and the move counts are the same in both runs.
* Every driver's history starts at the initial row: the first row of
  ``thetas`` is ``theta0`` for every chain.
"""

import numpy as np
import pytest
import torch

from glabc_tpu_torch import DiagGaussian, MA2Problem, MixtureProblem
from glabc_tpu_torch.ops.kernels.packed_kernel import unpack_history
from glabc_tpu_torch.samplers import (run_aglmcmc_fused,
                                      run_aglmcmc_fused_mixed,
                                      run_fused_program, run_glmala_fused,
                                      run_glmala_program, run_glmcmc_fused,
                                      run_glmcmc_nf_fused,
                                      run_glmcmc_nf_pooled)

torch.set_num_threads(1)

PROB = MixtureProblem(0.05)
IP = DiagGaussian.create(2, 0.0, 0.0)
LP = DiagGaussian.create(2, 0.0, float(np.log(0.35)))
THETA0 = np.asarray([0.3, -0.2], np.float32)
MA2 = MA2Problem()


def gen(seed):
    return torch.Generator().manual_seed(seed)


def _glmcmc(ch):
    r = run_glmcmc_fused(PROB, gen(1), 33, THETA0, num_chains=64,
                         steps_per_call=16, block_chains=32,
                         collect_history=ch, kernel="packed", device="cpu")
    return r, unpack_history(r.final_carry[0][None], 2)[:, 0]


def _glmala(ch):
    r = run_glmala_fused(PROB, gen(2), 17, THETA0, num_chains=32,
                         steps_per_call=8, num_grad=10, collect_history=ch,
                         device="cpu")
    return r, r.final_carry[0].T.numpy()


def _program(ch):
    r = run_fused_program(MA2, MA2.tile_program(), gen(3), 17, THETA0,
                          num_chains=16, steps_per_call=8,
                          collect_history=ch, device="cpu")
    return r, r.final_carry[0].T.numpy()


def _glmala_program(ch):
    r = run_glmala_program(MA2, MA2.tile_program(), gen(4), 17, THETA0,
                           num_chains=16, steps_per_call=8, num_grad=10,
                           collect_history=ch, device="cpu")
    return r, r.final_carry[0].T.numpy()


def _aglmcmc(ch):
    r = run_aglmcmc_fused(PROB, gen(5), 31, THETA0, IP, step_size=10,
                          num_chains=32, collect_history=ch, device="cpu")
    return r, r.final_carry.theta.numpy()


def _aglmcmc_mixed(ch):
    r = run_aglmcmc_fused_mixed(PROB, gen(6), 21, THETA0, IP,
                                global_frequency=0.5, batch_size=4,
                                step_size=5, shared_support=32,
                                redraw_chunk=4, num_chains=16,
                                collect_history=ch, device="cpu")
    return r, r.final_carry.theta.numpy()


def _nf_fused(ch):
    r = run_glmcmc_nf_fused(PROB, gen(7), 21, THETA0, step_size=10,
                            num_chains=16, n_layers=2, hidden=16,
                            collect_history=ch, device="cpu")
    return r, r.final_carry.theta.numpy()


def _nf_pooled(ch):
    r = run_glmcmc_nf_pooled(PROB, gen(8), 21, THETA0, LP,
                             global_frequency=0.5, step_size=5, num_chains=8,
                             n_layers=2, hidden=16, collect_history=ch,
                             device="cpu")
    return r, r.final_carry.theta.numpy()


DRIVERS = {"glmcmc_fused": _glmcmc, "glmala_fused": _glmala,
           "fused_program": _program, "glmala_program": _glmala_program,
           "aglmcmc_fused": _aglmcmc, "aglmcmc_fused_mixed": _aglmcmc_mixed,
           "glmcmc_nf_fused": _nf_fused, "glmcmc_nf_pooled": _nf_pooled}


@pytest.mark.parametrize("name", list(DRIVERS))
def test_no_history_returns_the_final_states(name):
    (off, final), (on, _) = DRIVERS[name](False), DRIVERS[name](True)
    C, n, d = on.thetas.shape
    assert off.thetas.shape == (C, 1, d)
    np.testing.assert_array_equal(off.thetas[:, -1], final)
    np.testing.assert_array_equal(off.thetas[:, -1], on.thetas[:, -1])
    np.testing.assert_array_equal(on.thetas[:, 0],
                                  np.broadcast_to(THETA0, (C, d)))
    assert not np.array_equal(off.thetas[:, -1], on.thetas[:, 0])
    for x, y in zip(off.counts, on.counts):
        np.testing.assert_array_equal(x, y)
