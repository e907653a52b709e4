"""The CUDA kernel on the card against its plain torch version.

These tests need an NVIDIA GPU with ``nvcc`` (they build
``glabc_tpu_torch/csrc`` at first use) and skip elsewhere.  They import no
JAX, so on a machine without it they run with the repository's JAX test
configuration left out::

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Kernel and plain version draw the same Philox stream; a chain counts as
differing when any of its values differs by more than 1e-5, and at most
0.1% may (an accept test exactly at its threshold can round either way).
"""

import numpy as np
import pytest
import torch

from glabc_tpu_torch import HighDimMixtureProblem, MixtureProblem
from glabc_tpu_torch.ops.kernels import (BatchedMixtureLogProb,
                                         FusedMixtureGLMCMC,
                                         PackedMixtureGLMCMC, PoolISIR,
                                         PoolISIRMixed, fused_state_init,
                                         kde_logprob_inputs,
                                         packed_state_init, resident_from_kde)
from glabc_tpu_torch.ops.kernels.philox import philox4x32, philox4x32_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(d):
    return MixtureProblem(0.05) if d == 2 else HighDimMixtureProblem(d)


def _kernel_and_state(layout, d, algorithm, device, chains=4096, T=16,
                      **kw):
    prob = _problem(d)
    cls = PackedMixtureGLMCMC if layout == "packed" else FusedMixtureGLMCMC
    kern = cls(d, prob.y_obs.numpy(), epsilon=prob.epsilon,
               sigma=prob._noise_std, steps_per_call=T, algorithm=algorithm,
               **kw)
    g = torch.Generator(device=device).manual_seed(0)
    if layout == "packed":
        state = packed_state_init(prob, g, np.zeros(d), chains // kern.pack,
                                  kern.pack, device=device)
    else:
        state = fused_state_init(prob, g, np.zeros(d), chains, kern.d_pad,
                                 device=device)
    return kern, state


def test_philox_cuda_known_answers(cuda):
    words = torch.tensor(
        [[0] * 6, [0xFFFFFFFF] * 6,
         [0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822,
          0x299F31D0]], dtype=torch.int64, device=cuda)
    want = [[0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8],
            [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD],
            [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]]
    assert philox4x32_cuda(words).tolist() == want
    rng = np.random.default_rng(0)
    rand = torch.from_numpy(rng.integers(0, 2**32, (4096, 6),
                                         dtype=np.uint64).astype(np.int64))
    plain = torch.stack(philox4x32(*(rand[:, i].to(cuda) for i in range(4)),
                                   0, 0), 1)
    rand[:, 4:] = 0
    assert torch.equal(philox4x32_cuda(rand.to(cuda)), plain)


CONFIGS = [("packed", d, a) for d in (1, 2, 4, 8) for a in ("glmcmc", "global")]
CONFIGS += [("unpacked", d, a) for d in (1, 2, 3, 5, 8, 12)
            for a in ("glmcmc", "global")]


@pytest.mark.parametrize("layout,d,algorithm", CONFIGS)
def test_kernel_matches_plain_version(cuda, layout, d, algorithm):
    kern, state = _kernel_and_state(layout, d, algorithm, cuda)
    before = type(kern).launches
    got = kern.run(11, *state, step0=32)
    assert type(kern).launches == before + 1
    want = kern.plain(11, *state, step0=32)
    torch.cuda.synchronize()
    ncols = state[0].shape[1]
    bad = torch.zeros(ncols, dtype=torch.bool, device=cuda)
    for a, b in zip([*got[:4], *got[4]], [*want[:4], *want[4]]):
        bad |= ((a - b).abs() > 1e-5).reshape(-1, ncols).any(0)
    assert bad.float().mean().item() <= 1e-3
    assert torch.allclose(got[3][0], want[3][0], rtol=0, atol=1e-5)


def test_block_chains_does_not_change_results(cuda):
    a_kern, state = _kernel_and_state("packed", 2, "glmcmc", cuda,
                                      block_chains=512)
    b_kern, _ = _kernel_and_state("packed", 2, "glmcmc", cuda,
                                  block_chains=64)
    a, b = a_kern.run(5, *state), b_kern.run(5, *state)
    for x, y in zip([*a[:4], *a[4]], [*b[:4], *b[4]]):
        assert torch.equal(x, y)


# ------------------------------------------------ AGLMCMC kernels (K3-K5)
def _pool_inputs(device, T, B, d, C, seed=0):
    """Random pool slices with about a fifth of the log-weights -inf."""
    g = torch.Generator(device=device).manual_seed(seed)
    f = dict(generator=g, device=device)
    ptheta = torch.randn((T, B, d, C), **f)
    logw = torch.randn((T, B, C), **f) * 3.0 - 4.0
    logw = torch.where(torch.rand((T, B, C), **f) < 0.2,
                       torch.full_like(logw, -float("inf")), logw)
    return ptheta, logw.contiguous(), g


@pytest.mark.parametrize("d", [2, 3, 8])
@pytest.mark.parametrize("B", [5, 7])
def test_pool_isir_matches_plain_bitwise(cuda, d, B):
    """K3 against its plain version: equal to the bit, -inf weights too."""
    T, C = 16, 4096
    ptheta, plogw, g = _pool_inputs(cuda, T, B, d, C)
    theta = torch.randn((d, C), generator=g, device=cuda)
    logw = torch.randn((C,), generator=g, device=cuda) - 4.0
    kern = PoolISIR(d, batch_size=B, steps_per_call=T, block_chains=128)
    before = PoolISIR.launches
    got = kern.run(9, ptheta, plogw, theta, logw, step0=400)
    assert PoolISIR.launches == before + 1
    want = kern.plain(9, ptheta, plogw, theta, logw, step0=400)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert 0.05 < float(got[3].mean()) / T < 0.95   # moves and stays


@pytest.mark.parametrize("d", [2, 3, 8])
@pytest.mark.parametrize("P", [1000, 250])
def test_kde_logprob_matches_plain(cuda, d, P):
    """K4 against its plain version, to 1e-4 max(1, |log q|): the two sum
    the same exponentials in another order."""
    from glabc_tpu_torch.models.kde import KernelDensity

    C = 64
    g = torch.Generator(device=cuda).manual_seed(d * P)
    X = torch.randn((C, P, d), generator=g, device=cuda)
    w = torch.rand((C, P), generator=g, device=cuda)
    w[:, ::7] = 0.0
    kdes = KernelDensity.fit(X, w)
    x = torch.randn((C, P, d), generator=g, device=cuda) * 1.5
    ms, pre, inv_h2 = kde_logprob_inputs(kdes)
    kern = BatchedMixtureLogProb()
    before = BatchedMixtureLogProb.launches
    got = kern.run(x, ms, pre, inv_h2)
    assert BatchedMixtureLogProb.launches == before + 1
    want = kern.plain(x, ms, pre, inv_h2)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
    assert err <= 1e-4
    # and against KernelDensity.log_prob (another formula) more loosely
    lp = kdes.log_prob(x)
    assert ((got - lp).abs() / lp.abs().clamp_min(1.0)).max().item() <= 1e-3


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("S", [1024, 100])
@pytest.mark.parametrize("gf", [0.5, 0.9])
def test_pool_isir_mixed_matches_plain(cuda, d, S, gf):
    """K5 against its plain version on one Philox stream: at most 0.1% of
    chains may differ (a decision at its threshold can round either way),
    and the first step's history equal."""
    from glabc_tpu_torch.models.kde import KernelDensity

    T, B, C = 32, 5, 4096
    prob = _problem(d)
    ptheta, plogw, g = _pool_inputs(cuda, T, B, d, C, seed=S)
    px = (ptheta.abs() + 0.2 * torch.randn(ptheta.shape, generator=g,
                                           device=cuda)).contiguous()
    plogk = torch.randn((T, B, C), generator=g, device=cuda) - 1.0
    kde = KernelDensity.fit(torch.randn((S, d), generator=g, device=cuda)
                            * 1.4)
    res = resident_from_kde(kde)
    theta = torch.randn((d, C), generator=g, device=cuda)
    y = (theta.abs() + 0.2 * torch.randn((d, C), generator=g,
                                         device=cuda)).contiguous()
    logk = prob.log_kernel_of_y(y.T.contiguous())
    kern = PoolISIRMixed(d, prob.y_obs.numpy(), epsilon=prob.epsilon,
                         sigma=prob._noise_std, global_frequency=gf,
                         batch_size=B, steps_per_call=T, block_chains=128)
    before = PoolISIRMixed.launches
    got = kern.run(3, res, ptheta, px, plogw, plogk, theta, y, logk,
                   step0=800)
    assert PoolISIRMixed.launches == before + 1
    want = kern.plain(3, res, ptheta, px, plogw, plogk, theta, y, logk,
                      step0=800)
    torch.cuda.synchronize()
    bad = torch.zeros(C, dtype=torch.bool, device=cuda)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        bad |= ((a - b).abs() > 1e-5).reshape(-1, C).any(0)
    assert bad.float().mean().item() <= 1e-3
    assert torch.equal(got[6][0], want[6][0])
    assert abs(got[3].mean().item() / T - gf) < 0.02


def test_shared_support_keeps_light_rows(cuda):
    """The shared epoch's systematic resampling over all C * P pool rows on
    the card: with 2^24 rows, half of them (at random) a quarter as heavy
    as the rest, those rows make a fifth of the picks.  A float32 CDF on
    the card drops increments below half an ulp of the running sum and
    misses this; the port's runs in float64."""
    from glabc_tpu_torch.samplers import aglmcmc as agl

    C, P = 1 << 12, 1 << 12
    g = torch.Generator(device=cuda).manual_seed(1)
    light = torch.rand((C, P), generator=g, device=cuda) < 0.5
    theta = torch.zeros((C, P, 2), device=cuda)
    theta[..., 0] = light.float() * 1e-3
    zeros = torch.zeros((C, P), device=cuda)
    log_q = torch.where(light, torch.full_like(zeros, float(np.log(4.0))),
                        zeros)
    pools = agl.Pool(theta, theta, zeros, log_q, zeros)
    picks = agl._shared_support(MixtureProblem(0.05), pools,
                                torch.tensor(1.0, device=cuda), 4096, g)
    share = float((picks[:, 0] > 5e-4).float().mean())
    assert abs(share - 0.2) < 0.02, share


# ------------------------------------------- GLMALA (K6) and the flow (K7)
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("coin_mode", ["shared", "per_chain"])
def test_glmala_matches_plain(cuda, d, coin_mode):
    """K6 against its plain version on one Philox stream: at most 0.1% of
    chains may differ by more than 1e-5 (an accept test at its threshold
    can round either way), and the first step's history equal."""
    from glabc_tpu_torch.ops.kernels import FusedMixtureGLMALA

    T, C = 8, 4096
    prob = _problem(d) if d > 1 else HighDimMixtureProblem(1)
    kern = FusedMixtureGLMALA(d, prob.y_obs.numpy(), epsilon=prob.epsilon,
                              sigma=prob._noise_std, global_frequency=0.5,
                              num_grad=50, steps_per_call=T,
                              block_chains=128, coin_mode=coin_mode)
    g = torch.Generator(device=cuda).manual_seed(d)
    theta = (torch.randn((d, C), generator=g, device=cuda) * 1.3).contiguous()
    y = (theta.abs() + 0.2 * torch.randn((d, C), generator=g,
                                         device=cuda)).contiguous()
    logk = prob.log_kernel_of_y(y.T.contiguous()).contiguous()
    grad = torch.randn((d, C), generator=g, device=cuda)
    coins = torch.tensor([1, 0, 0, 1, 0, 1, 0, 0], dtype=torch.int32)
    before = FusedMixtureGLMALA.launches
    got = kern.run(5, theta, y, logk, grad, coins, step0=64)
    assert FusedMixtureGLMALA.launches == before + 1
    want = kern.plain(5, theta, y, logk, grad, coins, step0=64)
    torch.cuda.synchronize()
    bad = torch.zeros(C, dtype=torch.bool, device=cuda)
    for a, b in zip([*got[:5], *got[5]], [*want[:5], *want[5]]):
        assert torch.isfinite(a).all()
        bad |= ((a - b).abs() > 1e-5).reshape(-1, C).any(0)
    assert bad.float().mean().item() <= 1e-3
    assert torch.allclose(got[4][0], want[4][0], rtol=0, atol=1e-5)
    assert 0.0 < got[5][3].sum().item() < C * T    # local accepts happen


def _flow_on(cuda, d, L=8, H=128, seed=0):
    from glabc_tpu_torch.models.flows import CouplingFlow

    g = torch.Generator(device=cuda).manual_seed(seed)
    f = CouplingFlow.create(d, L, H, generator=g, device=cuda)
    with torch.no_grad():   # a flow that is not the identity
        f.w2.copy_(torch.randn(f.w2.shape, generator=g, device=cuda) * 0.02)
        f.b2.copy_(torch.randn(f.b2.shape, generator=g, device=cuda) * 0.05)
    return f, g


@pytest.mark.parametrize("d,N", [(2, 4099), (3, 1000), (8, 777), (2, 64)])
@pytest.mark.parametrize("H", [128, 32])
def test_flow_kernel_matches_plain(cuda, d, N, H):
    """K7 push and pull against the plain flow (float32 matmuls), to 1e-4
    max(1, |x|): the kernel sums its products in another order."""
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush

    torch.backends.cuda.matmul.allow_tf32 = False
    f, g = _flow_on(cuda, d, H=H, seed=d + N)
    z = torch.randn((d, N), generator=g, device=cuda)
    for cls in (FlowPush, FlowPull):
        before = cls.launches
        out, s = cls().run(f, z)
        assert cls.launches == before + 1
        ref, s_ref = cls().plain(f, z)
        torch.cuda.synchronize()
        for a, b in ((out, ref), (s, s_ref)):
            assert torch.isfinite(a).all()
            err = ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()
            assert err <= 1e-4, (cls.__name__, err)
    x, s = FlowPush().run(f, z)
    back, s_b = FlowPull().run(f, x)
    assert torch.allclose(back, z, rtol=1e-4, atol=1e-4)
    assert torch.allclose(s_b, s, rtol=1e-4, atol=1e-4)


def test_flow_plain_refuses_tf32(cuda):
    from glabc_tpu_torch.ops.kernels import FlowPush

    f, g = _flow_on(cuda, 2, L=2, H=16)
    z = torch.randn((2, 64), generator=g, device=cuda)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            FlowPush().plain(f, z)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
