"""K4 and K5 as the H100 kernels compute them, on the CPU.

* K5's resident density, ``resident_log_q``, in the kernel's warp order
  (component i on lane i % 32, per-lane sums in rising order, an xor
  butterfly over the lanes): against glabc_tpu's densities at 1e-5 for S
  in {1, 37, 100, 1024}, and bit for bit against the same order written
  out lane by lane in numpy.
* The kernel carries log q(theta) and the prior while a chain stays:
  ``run_plain`` with that cache (the carried values checked against a
  recomputation at every step) is bitwise ``run_plain``, for the built-in
  move and the MA(2) program's.
* K4's log2-domain arithmetic (pre and ms scaled by log2 e, fused
  multiply-adds, chunks of 16 components with a running max, exp2), emulated
  in torch, stays within 1e-4 max(1, |log q|) of the plain version.
* The launch geometry (``default_launch``) and ``chip_smoke.py``'s
  counts for the new bounds and the K4 SASS line.
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glabc_tpu.models.kde import KernelDensity as JKDE
from glabc_tpu_torch.models import KernelDensity
from glabc_tpu_torch.ops.kernels import (BatchedMixtureLogProb,
                                         PoolISIRMixed, kde_logprob_inputs,
                                         resident_from_kde)
from glabc_tpu_torch.ops.kernels import pool_isir_mixed_kernel as pim
from glabc_tpu_torch.utils.convert import (kde_from_numpy,
                                           ma2_problem_from_numpy)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _resident(S, seed, d=2):
    rng = np.random.default_rng(seed)
    X = (1.4 * rng.normal(size=(S, d))).astype(np.float32)
    w = rng.uniform(size=S).astype(np.float32)
    if S > 5:
        w[5] = 0.0
    jk = JKDE.fit(jnp.asarray(X), jnp.asarray(w), bandwidth=0.4)
    res = resident_from_kde(kde_from_numpy(jk.X, jk.weights, jk.bandwidth))
    pts = (1.5 * rng.normal(size=(64, d))).astype(np.float32)
    return jk, res, pts


# --------------------------------------------------- K5 resident density
@pytest.mark.parametrize("S", [1, 37, 100, 1024])
def test_resident_log_q_matches_jax_densities(S):
    jk, res, pts = _resident(S, S)
    np.testing.assert_allclose(
        pim.resident_log_q(res, torch.from_numpy(pts)).numpy(),
        np.asarray(jk.log_prob(jnp.asarray(pts))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [1, 37, 100, 1024])
def test_resident_log_q_is_the_lane_butterfly(S):
    """The same exponentials summed lane by lane in numpy float32: lane l
    adds components l, l + 32, ... in rising order, then each lane adds its
    xor partner at offsets 16, 8, 4, 2, 1; every lane ends equal."""
    _, res, pts = _resident(S, 7 * S + 1)
    th = torch.from_numpy(pts)
    sc = (res.mu_scaled[None, :, 0] * th[:, :1]
          + res.mu_scaled[None, :, 1] * th[:, 1:2]) + res.pre[None, :]
    m = torch.clamp_min(torch.amax(sc, dim=-1), -1.0e30)
    e = torch.exp(sc - m[:, None]).numpy()
    sums = np.empty(len(pts), np.float32)
    for c in range(len(pts)):
        lanes = np.zeros(32, np.float32)
        for i in range(S):
            lanes[i % 32] = np.float32(lanes[i % 32] + e[c, i])
        for off in (16, 8, 4, 2, 1):
            lanes = (lanes + lanes[np.arange(32) ^ off]).astype(np.float32)
        assert np.all(lanes == lanes[0])
        sums[c] = lanes[0]
    q2 = (th[:, 0] * th[:, 0]) * res.inv2h[0] + (th[:, 1] * th[:, 1]) \
        * res.inv2h[1]
    want = (torch.log(torch.from_numpy(sums)) + m) - 0.5 * q2
    assert torch.equal(pim.resident_log_q(res, th), want)


def _builtin_case(C, T, B, S, gf, seed):
    g = torch.Generator().manual_seed(seed)
    d = 2
    ptheta = torch.randn((T, B, d, C), generator=g) * 1.4
    px = (ptheta.abs() + 0.2 * torch.randn(ptheta.shape, generator=g))
    plogw = torch.randn((T, B, C), generator=g) * 3.0 - 4.0
    plogk = torch.randn((T, B, C), generator=g) - 1.0
    theta = torch.randn((d, C), generator=g)
    y = (theta.abs() + 0.2 * torch.randn((d, C), generator=g))
    logk = torch.randn((C,), generator=g) - 1.0
    res = resident_from_kde(KernelDensity.fit(
        torch.randn((S, d), generator=g) * 1.4))
    kern = PoolISIRMixed(d, [1.5, 1.5], epsilon=0.5, sigma=0.05,
                         global_frequency=gf, batch_size=B, steps_per_call=T)
    return kern, (res, ptheta, px.contiguous(), plogw, plogk, theta,
                  y.contiguous(), logk)


def _ma2_case(C, T, B, S, gf, seed):
    prob = ma2_problem_from_numpy(np.array([1.2, 0.5, 0.2], np.float32),
                                  0.3, 16)
    g = torch.Generator().manual_seed(seed)
    box = torch.tensor([4.0, 2.0])[:, None]
    low = torch.tensor([-2.0, -1.0])[:, None]
    ptheta = (torch.rand((T, B, 2, C), generator=g) * box + low) * 0.5
    px = 0.5 + 0.5 * torch.randn((T, B, 3, C), generator=g)
    plogw = torch.randn((T, B, C), generator=g) * 2.0 - 3.0
    plogk = torch.randn((T, B, C), generator=g) - 2.0
    theta = (torch.rand((2, C), generator=g) - 0.5) * 0.6
    y = 0.5 + 0.5 * torch.randn((3, C), generator=g)
    logk = torch.randn((C,), generator=g) - 2.0
    res = resident_from_kde(KernelDensity.fit(
        torch.randn((S, 2), generator=g) * 0.3))
    kern = PoolISIRMixed(2, program=prob.tile_program(lp_scale=0.1),
                         global_frequency=gf, batch_size=B, steps_per_call=T)
    return kern, (res, ptheta, px, plogw, plogk, theta.contiguous(), y, logk)


@pytest.mark.parametrize("case", ["builtin", "ma2"])
@pytest.mark.parametrize("gf", [0.5, 0.9])
def test_carried_density_changes_nothing(monkeypatch, case, gf):
    """``run_plain`` with the kernel's cache: log q is carried and replaced
    only for chains whose last step moved.  At every step the carried value
    of an unmoved chain equals its recomputation to the bit, and the
    launch's outputs equal ``run_plain``'s."""
    C, T, B, S = 64, 24, 5, 100
    make = _builtin_case if case == "builtin" else _ma2_case
    kern, args = make(C, T, B, S, gf, 3)
    want = kern.plain(11, *args, step0=500)

    orig_lq = pim.resident_log_q
    name = "mixed_transition" if case == "builtin" else "program_transition"
    orig_step = getattr(pim, name)
    cache = {}

    def carried_log_q(res, theta):
        fresh = orig_lq(res, theta)
        if "lq" not in cache:
            cache["lq"] = fresh
            return fresh
        stay = ~cache["moved"]
        assert torch.equal(fresh[stay], cache["lq"][stay])
        cache["lq"] = torch.where(cache["moved"], fresh, cache["lq"])
        cache["computed"] += int(cache["moved"].sum())
        return cache["lq"]

    def step(*a, **kw):
        out, inc = orig_step(*a, **kw)
        cache["moved"] = (inc[1] + inc[2]) > 0
        return out, inc

    cache["computed"] = C
    monkeypatch.setattr(pim, "resident_log_q", carried_log_q)
    monkeypatch.setattr(pim, name, step)
    got = kern.plain(11, *args, step0=500)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    moves = float(want[4].sum() + want[5].sum())
    assert 0 < cache["computed"] < C * T and moves > 0


def test_default_launch():
    """32 chains a warp while every scheduler (4 an SM) gets a warp, else
    16; then the largest block that still gives every SM one."""
    f = pim.default_launch
    assert f(65536, 132) == (256, 32)
    assert f(32 * 528, 132) == (128, 32)   # 528 warps: one a scheduler
    assert f(16384, 132) == (128, 16)      # 1,024 warps in 256 blocks
    assert f(8192, 132) == (64, 16)
    assert f(4113, 132) == (32, 16) and f(1, 132) == (32, 16)
    assert PoolISIRMixed(2, [1.5, 1.5]).C_blk is None
    assert PoolISIRMixed(2, [1.5, 1.5], block_chains=64).C_blk == 64
    with pytest.raises(ValueError, match="block_chains"):
        PoolISIRMixed(2, [1.5, 1.5], block_chains=48)


# ------------------------------------------------------ K4, log2 domain
def _fma(a, b, c):
    """float32 fused multiply-add (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def k4_log2_emulation(x, ms, pre, inv_h2, K=16):
    """K4's arithmetic: terms t = fma(x_f, ms_f log2 e, ...) from
    pre log2 e, chunks of K components (padded with -inf), the chunk max
    folded into a running max that rescales the running sum by exp2, and
    (max ln 2 + log sum) - 0.5 q2."""
    C, N, d = x.shape
    log2e = torch.tensor(1.0 / math.log(2.0), dtype=torch.float32)
    ln2 = torch.tensor(math.log(2.0), dtype=torch.float32)
    t = (pre * log2e)[:, None, :].expand(C, N, -1)
    ms2 = ms * log2e
    for f in range(d):
        t = _fma(x[:, :, f:f + 1], ms2[:, None, :, f], t)
    pad = -t.shape[-1] % K
    t = torch.cat([t, torch.full((C, N, pad), -math.inf)], dim=-1)
    t = t.reshape(C, N, -1, K)
    m = torch.full((C, N), -math.inf)
    s = torch.zeros((C, N))
    for j in range(t.shape[2]):
        chunk = t[:, :, j]
        mn = torch.maximum(m, chunk.amax(-1))
        s = s * torch.exp2(m - mn)
        for k in range(K):
            s = s + torch.exp2(chunk[..., k] - mn)
        m = mn
    q2 = (x[:, :, 0] * x[:, :, 0]) * inv_h2[:, :1]
    for f in range(1, d):
        q2 = q2 + (x[:, :, f] * x[:, :, f]) * inv_h2[:, f:f + 1]
    return (m * ln2 + torch.log(s)) - 0.5 * q2


@pytest.mark.parametrize("d", [1, 2, 3, 8])
def test_kde_log2_domain_stays_within_tolerance(d):
    C, N, P = 6, 150, 250
    g = torch.Generator().manual_seed(d)
    X = torch.randn((C, P, d), generator=g)
    w = torch.rand((C, P), generator=g)
    w[:, ::7] = 0.0
    kdes = KernelDensity.fit(X, w)
    x = torch.randn((C, N, d), generator=g) * 1.5
    args = (x, *kde_logprob_inputs(kdes))
    want = BatchedMixtureLogProb().plain(*args)
    got = k4_log2_emulation(*args)
    err = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
    assert torch.isfinite(got).all() and err <= 1e-4


# -------------------------------------------------- chip_smoke.py counts
SASS = """\
        Function : _ZN5glabc18kde_logprob_kernelILi2EEEvNS_7KdeArgsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FFMA R5, R4, R6, R7 ;
        /*0030*/                   FMNMX R1, R2, R3, !PT ;
        /*0040*/                   FADD R6, R5, -R1 ;
        /*0050*/                   MUFU.EX2 R6, R6 ;
        /*0060*/              @P1  BRA 0x10 ;
        /*0070*/                   IADD3 R2, R2, 0x80, RZ ;
        /*0080*/              @P2  BRA 0x10 ;
        /*0090*/                   EXIT ;
"""


def test_k4_inner_loop_on_a_synthetic_listing():
    """The innermost loop holding a MUFU, by class; another kernel's name
    finds nothing."""
    cs = _chip_smoke()
    assert cs.k4_inner_loop(SASS) == {"MUFU": 1, "FFMA": 1,
                                      "FADD/FMUL/FMNMX": 2, "LDS": 1,
                                      "other": 1}
    assert cs.k4_inner_loop(SASS, "no_such_kernel") is None


def test_resident_recomputes_and_bound():
    """Chain-steps needing the resident density: every chain's first step
    and each step whose starting state differs from the step before's."""
    cs = _chip_smoke()
    T, C = 4, 40
    theta_in = torch.zeros((2, C))
    hist = torch.zeros((T, 2, C))
    hist[0:, 0, 3] = 1.0          # chain 3 moves at step 0, then stays
    hist[2:, 1, 35] = 2.0         # chain 35 moves at step 2
    n, share, lanes, any_share = cs.resident_recomputes(theta_in, hist)
    # steps 0: 40 chains; step 1: chain 3; step 3: chain 35
    assert n == 42 and share == 42 / (T * C)
    # two warps (the second holds 8 chains): lanes per warp-step
    assert lanes == 42 / (T * 2) and any_share == 4 / 8
    assert cs.resident_ops(2, 1024) == (5120, 1025)
    ops, sfu = cs.mixed_isir_ops(2, 5, 1024)
    assert ops > 5120 and sfu > 1025
