"""The paired simulation of a gradient replicate and the recounted kernel
bounds, on the CPU.

* ``TileProgram.simulate_pair`` (the torch twin of the headers'
  ``simulate_pair``, K9's +-fd pair on one cursor) against two
  ``simulate`` calls on two cursors over the same blocks, bit for bit,
  for the MA(2) program at odd and even ``num_draws`` and the Mixture
  program at d = 2 and 3 on paired and unpaired cursors.
* A synthetic-likelihood gradient built from ``simulate_pair`` equals
  ``program_sl_grad`` (two ``simulate`` calls, the kernel's reference) bit
  for bit; ``program_sl_grad`` itself is held to the JAX estimator in
  ``tests/test_torch_generic.py``.
* ``chip_smoke.py``'s operation counts: K1's by move and the old count of
  both moves, and K9's +-fd pair against two whole simulations, against
  their hand counts at d=2, B=5 and num_draws=100; and its SASS reading
  (``sass_loop_split``, ``sass_counts``) on a synthetic listing.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from glabc_tpu_torch import HighDimMixtureProblem, MA2Problem, MixtureProblem
from glabc_tpu_torch.ops.kernels.generic_kernel import philox_draws
from glabc_tpu_torch.ops.kernels.generic_glmala_kernel import (
    ProgMalaConfig, _sl_lp, program_sl_grad)
from glabc_tpu_torch.ops.kernels.philox import Draws
from glabc_tpu_torch.ops.kernels.program import div, mixture_tile_program

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
C = 64


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _programs():
    return [("ma2_even", MA2Problem(num_draws=16,
                                    y_obs=[1.0, 0.4, 0.0]).tile_program()),
            ("ma2_odd", MA2Problem(num_draws=37,
                                   y_obs=[1.0, 0.4, 0.0]).tile_program()),
            ("ma2_100", MA2Problem().tile_program()),
            ("mixture2", mixture_tile_program(MixtureProblem(0.05))),
            ("mixture3", mixture_tile_program(HighDimMixtureProblem(3)))]


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("name,prog", _programs())
def test_simulate_pair_is_two_simulations(name, prog, paired):
    rng = np.random.default_rng(7)
    chains = torch.arange(C) * 3 + 1
    d = prog.theta_dim
    for fd in (0.1, 0.013, 0.0):
        th = torch.from_numpy(rng.uniform(-0.9, 0.9, (d, C)).astype(
            np.float32))
        e = torch.zeros((d, 1))
        e[int(rng.integers(d))] = float(np.float32(fd))
        ta, tb = th + e, th - e
        first = torch.from_numpy(rng.integers(0, 500, C))
        cur = lambda: Draws(5, chains, 11, first, paired)
        ya, yb = prog.simulate_pair(ta, tb, cur())
        assert torch.equal(ya, prog.simulate(ta, cur()))
        assert torch.equal(yb, prog.simulate(tb, cur()))
        if fd:
            assert not torch.equal(ya, yb)


@pytest.mark.parametrize("name,prog", [_programs()[1], _programs()[3]])
def test_gradient_from_pairs_is_program_sl_grad(name, prog):
    """The kernel's gradient as simulate_pair computes it, replicate by
    replicate in order, against program_sl_grad."""
    cfg = ProgMalaConfig(prog, epsilon=0.2, global_frequency=0.8,
                         batch_size=5, tau=0.1, num_grad=7, fd_step=0.1)
    rng = np.random.default_rng(3)
    th = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, C)).astype(np.float32))
    draws = philox_draws(2, C, "cpu")
    want = program_sl_grad(cfg, draws, 9, th)
    rows = []
    for k in range(2):
        e = torch.zeros((2, 1))
        e[k] = cfg.fd
        s1p = s2p = s1m = s2m = None
        for r in range(cfg.n_grad):
            blk = cfg.grad_block + (r * 2 + k) * prog.sim_blocks
            yp, ym = prog.simulate_pair(th + e, th - e, draws(9, blk))
            dp, dm = prog.discrepancy(yp), prog.discrepancy(ym)
            if s1p is None:
                s1p, s2p, s1m, s2m = dp, dp * dp, dm, dm * dm
            else:
                s1p, s2p = s1p + dp, s2p + dp * dp
                s1m, s2m = s1m + dm, s2m + dm * dm
        rows.append(div(_sl_lp(cfg, s1p, s2p) - _sl_lp(cfg, s1m, s2m),
                        cfg.two_fd))
    got = torch.stack(rows) + prog.prior_grad(th)
    assert torch.equal(got, want)


def test_k1_operation_counts():
    """K1 at d=2, B=5 (the hand counts of chip_smoke.transition_ops)."""
    cs = _chip_smoke()
    # both moves, the old count: 8 blocks (640), 32 uniforms (160), 12
    # pairs (96), candidates (60), 13 Gaussians (156), 6 kernels (48),
    # Gumbels (24), iSIR (58), local MH, coin, selects, counters (24)
    assert cs.transition_ops_both(2, 5, True) == 1266
    assert cs.transition_ops_both(2, 5, False) == 460
    # iSIR: 7 blocks (560), 27 uniforms (135), 10 pairs and candidates
    # (130), 11 Gaussians (132), 5 kernels (40), Gumbels and iSIR (82),
    # coin, counters and selects (10)
    assert cs.transition_ops(2, 5, True, "global") == 1089
    # random walk: 2 blocks (160), 6 uniforms (30), a pair and candidate
    # (26), one Gaussian (12), a kernel (8), MH (5), the rest (10)
    assert cs.transition_ops(2, 5, True, "local") == 251
    # independence MH: 2 blocks, 6 uniforms, one pair, 3 Gaussians
    assert cs.transition_ops(2, 5, False, "global") == 277
    assert cs.transition_ops(2, 5, False, "local") == 251
    # B = 7: the Gumbels 0..7 span two blocks, the local slots one
    assert cs.transition_ops(2, 7, True, "local") == 251
    mix = cs.transition_ops_mix(2, 5, True, 1000, 900)
    assert mix == 900 * 1089 + 100 * 251
    assert mix < 1000 * 1266


def test_k9_operation_counts():
    """One +-fd pair of MA(2) simulations at num_draws=100 draws its 102
    innovations once: 26 blocks (2,080), 102 uniforms (510), 51 pairs'
    multiplies (204) and two recursions (2 x 1,003)."""
    cs = _chip_smoke()
    assert cs.ma2_sim_ops(100) == (3797, 204)
    assert cs.ma2_sim_pair_ops(100) == (4800, 204)
    assert cs.ma2_sim_pair_ops(101)[0] == 2080 + 520 + 208 + 2 * 1013
    om, sm = cs.ma2_step_ops(100, 5, "mala", 100)
    oo, so = cs.ma2_step_ops(100, 5, "mala", 100, pair=False)
    kern = cs._MA2_KERN
    # the gradient's 200 replicates: a pair, or two simulations, each with
    # its two discrepancies (the epsilon-kernel's work and 4 more)
    assert oo - om == 200 * (2 * 3797 - 4800)
    assert so - sm == 200 * 204
    assert om == (80 * 2 + 5 * 8 + 20 + 80 + 36 + 8 + 3797 + kern
                  + 200 * (4800 + 2 * (kern + 4)) + 80 + 40)


SASS = """\
        Function : _ZN5glabc21mixture_glmcmc_kernelILi2ELb1EEEvNS_7BuffersENS_6ParamsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IMAD.HI.U32 R2, R3, R4, RZ ;
        /*0020*/                   LOP3.LUT R5, R2, R6, R7, 0x96, !PT ;
        /*0030*/                   MUFU.LG2 R6, R7 ;
        /*0040*/              @P1  BRA 0x20 ;
        /*0050*/                   FADD R1, R2, R3 ;
        /*0060*/              @!P0 BRA 0x90 ;
        /*0070*/                   LDG.E R1, desc[UR4][R2.64] ;
        /*0080*/                   FMUL R1, R1, R2 ;
        /*0090*/                   BRA 0x10 ;
        /*00a0*/                   EXIT ;
"""


def test_sass_loop_split_on_a_synthetic_listing():
    """The step loop is the largest backward branch, the candidate rounds
    the largest loop inside it, and a predicated forward skip over a load
    (a cold range reduction) is left out of both."""
    cs = _chip_smoke()
    split = cs.sass_loop_split(SASS, "mixture_glmcmc_kernelILi2E")
    zero = dict.fromkeys([c for c, _ in cs.SASS_CLASSES] + ["other"], 0)
    assert split["rounds"] == {**zero, "LOP3": 1, "MUFU": 1, "other": 1}
    assert split["step_rest"] == {**zero, "IMAD.WIDE/HI": 1,
                                  "FADD/FMUL": 1, "other": 2}
    assert cs.sass_loop_split(SASS, "no_such_kernel") is None
    counts = cs.sass_counts(None, text=SASS)
    assert list(counts.values()) == [11]
    assert cs.sass_counts(None, "LOP3", text=SASS) == {
        next(iter(counts)): 1}
