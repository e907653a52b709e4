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


@pytest.mark.parametrize("gf", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("algorithm", ["glmcmc", "global"])
@pytest.mark.parametrize("layout,d", [("packed", 2), ("unpacked", 3),
                                      ("unpacked", 5), ("unpacked", 12)])
def test_kernel_matches_plain_at_every_coin_share(cuda, layout, d,
                                                  algorithm, gf):
    """The kernel reads each chain's coin first and computes only the move
    it picks, in one loop of candidate rounds: all-local, mixed and
    all-global warps, the register builds and the scratch build (d=5, 12),
    against the plain version, which computes both moves and selects."""
    kern, state = _kernel_and_state(layout, d, algorithm, cuda,
                                    global_frequency=gf)
    got = kern.run(13, *state, step0=64)
    want = kern.plain(13, *state, step0=64)
    torch.cuda.synchronize()
    ncols = state[0].shape[1]
    bad = torch.zeros(ncols, dtype=torch.bool, device=cuda)
    for a, b in zip([*got[:4], *got[4]], [*want[:4], *want[4]]):
        assert torch.isfinite(a).all()
        bad |= ((a - b).abs() > 1e-5).reshape(-1, ncols).any(0)
    assert bad.float().mean().item() <= 1e-3
    for a, b in zip(got[4], want[4]):
        assert torch.equal(a, b)
    g_share = got[4].global_attempts.sum().item() / (4096 * kern.T)
    assert abs(g_share - gf) < 0.03
    assert got[4].accepted.sum().item() > 0


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


@pytest.mark.parametrize("d,N", [(2, 4099), (3, 1000), (8, 777), (2, 64),
                                 (17, 300)])
@pytest.mark.parametrize("H", [128, 32, 8, 48])
def test_flow_kernel_matches_plain(cuda, d, N, H):
    """K7 push and pull against the plain flow (float32 matmuls), to 1e-4
    max(1, |x|): the kernel's 3xTF32 split products and its sums in another
    order keep float32 accuracy, not bitwise equality."""
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


@pytest.mark.parametrize("d,N", [(2, 4099), (3, 1000), (8, 777), (17, 300)])
def test_flow_kernel_keeps_split_precision(cuda, d, N):
    """K7 within 3e-6 of the plain flow, where one TF32 product (the hi
    parts alone, emulated on the same inputs) is not: chip_smoke.py's
    FLOW_SPLIT_TOL, which tells the 3xTF32 split from a plain TF32 kernel,
    as 1e-4 does not."""
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush
    from glabc_tpu_torch.ops.kernels.flow_kernel import tf32_products

    torch.backends.cuda.matmul.allow_tf32 = False
    f, g = _flow_on(cuda, d, seed=d + N)
    z = torch.randn((d, N), generator=g, device=cuda)
    rel = lambda got, want: max(
        ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()
        for a, b in zip(got, want))
    for cls in (FlowPush, FlowPull):
        want = cls().plain(f, z)
        err = rel(cls().run(f, z), want)
        one = rel(tf32_products(f, z, cls.inverse, split=False), want)
        assert err <= 3e-6 < one, (cls.__name__, err, one)


def test_flow_kernel_sees_a_training_step(cuda):
    """The weight image kept on the flow is made again after an in-place
    step, so the kernel runs the new weights."""
    from glabc_tpu_torch.ops.kernels import FlowPull

    torch.backends.cuda.matmul.allow_tf32 = False
    f, g = _flow_on(cuda, 2, L=4, H=32)
    x = torch.randn((2, 500), generator=g, device=cuda)
    before = FlowPull().run(f, x)
    with torch.no_grad():
        f.w2.add_(torch.randn(f.w2.shape, generator=g, device=cuda) * 0.1)
    got, want = FlowPull().run(f, x), FlowPull().plain(f, x)
    assert not torch.allclose(got[1], before[1], rtol=1e-3, atol=1e-3)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4)


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


# ------------------------------- the bf16-operand coupling flow (K7-bf16)
# A row differs when any of its outputs is more than BF16_ROW_TOL max(1,
# |plain|) from the plain bf16 version's; at most BF16_SHARE of the rows may,
# none by more than BF16_MAX_TOL (chip_smoke.py gives the reason).
BF16_ROW_TOL, BF16_SHARE, BF16_MAX_TOL = 1e-4, 1e-4, 1e-3


def _row_diff(got, want):
    """Per row, the largest difference over its coordinates and its
    log-scale sum, relative to max(1, |plain|)."""
    rel = lambda a, b: (a - b).abs() / b.abs().clamp_min(1.0)
    return torch.maximum(rel(got[0], want[0]).amax(0), rel(got[1], want[1]))


def _integer_flow(cuda, d, H, seed):
    """One layer whose every product operand is a small integer (or one
    scaled by a power of two), so that each sum is exact in float32 in any
    order: the kernel must equal the plain version wherever the fragments
    put every element in its place."""
    from glabc_tpu_torch.models.flows import CouplingFlow

    g = torch.Generator(device=cuda).manual_seed(seed)
    ints = lambda shape, lo, hi: torch.randint(lo, hi, shape, generator=g,
                                               device=cuda).float()
    d2 = d // 2
    d1 = d - d2
    w2 = ints((1, H, 2 * d2), -1, 2)
    w2[..., d2:] *= 2.0 ** -16            # s small enough for exp
    f = CouplingFlow(torch.zeros(d, device=cuda), torch.zeros(d, device=cuda),
                     ints((1, d1, H), 0, 2), ints((1, H), -1, 2),
                     ints((1, H, H), -1, 2), ints((1, H), -2, 3), w2,
                     ints((1, 2 * d2), -2, 3))
    return f, ints((d, 300), 0, 3)


@pytest.mark.parametrize("d", [2, 8, 17])
@pytest.mark.parametrize("H", [8, 16, 48, 128])
def test_flow_fragments_on_integers(cuda, d, H):
    """The float32 kernel on an integer-valued flow: every split product is
    exact (the lo parts are 0) and every sum too, so the log-scale sums must
    equal the plain version's bit for bit, for padded widths as well."""
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush

    torch.backends.cuda.matmul.allow_tf32 = False
    f, z = _integer_flow(cuda, d, H, seed=d * H + 1)
    for cls in (FlowPush, FlowPull):
        got = cls().run(f, z)
        want = cls().plain(f, z)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), cls.__name__   # exact sums
        assert torch.allclose(got[0], want[0], rtol=1e-6, atol=0)


@pytest.mark.parametrize("d", [2, 8, 17])
@pytest.mark.parametrize("H", [16, 48, 128])
def test_flow_bf16_fragments_on_integers(cuda, d, H):
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush

    torch.backends.cuda.matmul.allow_tf32 = False
    f, z = _integer_flow(cuda, d, H, seed=d * H)
    for cls in (FlowPush, FlowPull):
        got = cls("bfloat16").run(f, z)
        want = cls("bfloat16").plain(f, z)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), cls.__name__   # exact sums
        assert torch.allclose(got[0], want[0], rtol=1e-6, atol=0)


@pytest.mark.parametrize("d,N", [(2, 4099), (3, 1000), (8, 777), (17, 300)])
@pytest.mark.parametrize("H", [128, 32, 16])
def test_flow_bf16_kernel_matches_plain(cuda, d, N, H):
    """K7-bf16 push and pull against the plain bf16 flow; the float32 flow at
    the same inputs fails the same check by far (it is not a bf16 flow)."""
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush

    torch.backends.cuda.matmul.allow_tf32 = False
    f, g = _flow_on(cuda, d, L=8 if H == 128 else 4, H=H, seed=d + N + H)
    z = torch.randn((d, N), generator=g, device=cuda)
    for cls in (FlowPush, FlowPull):
        before = (cls.launches, cls.bf16_launches)
        got = cls("bfloat16").run(f, z)
        assert (cls.launches, cls.bf16_launches) == (before[0],
                                                     before[1] + 1)
        want = cls("bfloat16").plain(f, z)
        f32 = cls().plain(f, z)
        torch.cuda.synchronize()
        assert all(torch.isfinite(a).all() for a in got)
        diff = _row_diff(got, want)
        assert (diff > BF16_ROW_TOL).float().mean() <= BF16_SHARE, cls
        assert diff.max() <= BF16_MAX_TOL, (cls.__name__, diff.max())
        sep = (_row_diff(f32, want) > BF16_ROW_TOL).float().mean()
        assert sep >= 10 * BF16_SHARE, (cls.__name__, sep)


def test_flow_bf16_pull_inverts_push(cuda):
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush

    f, g = _flow_on(cuda, 2, L=32, H=128, seed=5)
    z = torch.randn((2, 1 << 16), generator=g, device=cuda)
    x, s = FlowPush("bfloat16").run(f, z)
    back, s_b = FlowPull("bfloat16").run(f, x)
    # bf16 roundings amplify the float32 rounding of each inverse step: the
    # plain bf16 flow's own round trip is ~2.4e-4 here (float32's ~2.4e-6)
    assert torch.allclose(back, z, rtol=2e-3, atol=2e-3)
    assert torch.allclose(s_b, s, rtol=2e-3, atol=2e-3)


_BF16_WIDTHS = (16, 32, 48, 64, 80, 96, 112, 128)
_BF16_DIMS = (2, 3, 8, 17)
_BF16_ROWS = (1, 63, 64, 65, 8209)


def _bf16_against_plain(cuda, H, d, N):
    """K7-bf16 push and pull on a 4-layer flow at (H, d, N) beside the
    plain bf16 and float32 flows: ``{class: (kernel's outputs, row
    differences from the plain bf16 flow, the float32 flow's)}``."""
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush

    torch.backends.cuda.matmul.allow_tf32 = False
    f, g = _flow_on(cuda, d, L=4, H=H, seed=H + d + N)
    z = torch.randn((d, N), generator=g, device=cuda)
    out = {}
    for cls in (FlowPush, FlowPull):
        got = cls("bfloat16").run(f, z)
        want = cls("bfloat16").plain(f, z)
        f32 = cls().plain(f, z)
        torch.cuda.synchronize()
        assert all(torch.isfinite(a).all() for a in got)
        out[cls] = (got, _row_diff(got, want), _row_diff(f32, want))
    return f, z, out


@pytest.mark.parametrize("N", _BF16_ROWS)
@pytest.mark.parametrize("d", _BF16_DIMS)
@pytest.mark.parametrize("H", _BF16_WIDTHS)
def test_flow_bf16_every_width_and_ragged_rows(cuda, H, d, N):
    """K7-bf16 (wgmma, one instantiation per H / 16) at every hidden width
    and row counts around its 64-row tile: push and pull finite, no row
    further than BF16_MAX_TOL from the plain bf16 flow, pull(push(z))
    giving z back as the plain flow's round trip does, and at 8,209 rows
    the float32 flow missing BF16_ROW_TOL tenfold as often as BF16_SHARE
    allows (the kernel is a bf16 flow).  The share of rows beyond
    BF16_ROW_TOL is a rate: it is held over the rows of every shape at
    once (``test_flow_bf16_share_over_every_shape``)."""
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush

    f, z, out = _bf16_against_plain(cuda, H, d, N)
    for cls, (_, diff, diff32) in out.items():
        assert diff.max() <= BF16_MAX_TOL, (cls.__name__, diff.max())
        if N > 8192:
            sep = (diff32 > BF16_ROW_TOL).float().mean()
            assert sep >= 10 * BF16_SHARE, (cls.__name__, sep)
    x, s = out[FlowPush][0]
    back, s_b = FlowPull("bfloat16").run(f, x)
    assert torch.allclose(back, z, rtol=2e-3, atol=2e-3)
    assert torch.allclose(s_b, s, rtol=2e-3, atol=2e-3)


def test_flow_bf16_share_over_every_shape(cuda):
    """Over the rows of every (H, d, N) of the test above, push and pull
    (537,728 rows), at most BF16_SHARE differ from the plain bf16 flow by
    more than BF16_ROW_TOL, and the float32 flow on at least ten times as
    many: the limits as chip_smoke.py holds its many-row checks to."""
    rows = bad = bad32 = 0
    for H in _BF16_WIDTHS:
        for d in _BF16_DIMS:
            for N in _BF16_ROWS:
                for _, diff, diff32 in _bf16_against_plain(cuda, H, d,
                                                           N)[2].values():
                    rows += diff.numel()
                    bad += int((diff > BF16_ROW_TOL).sum())
                    bad32 += int((diff32 > BF16_ROW_TOL).sum())
    assert bad <= BF16_SHARE * rows, (bad, rows)
    assert bad32 >= 10 * BF16_SHARE * rows, (bad32, rows)


@pytest.mark.parametrize("H", [513, 600, 1024])
def test_flow_bf16_refuses_other_widths(cuda, H):
    """Past 512 hidden units neither bf16 kernel takes a flow: the launch
    raises before anything runs."""
    from glabc_tpu_torch.ops.kernels import FlowPush

    f, g = _flow_on(cuda, 2, L=2, H=H)
    z = torch.randn((2, 64), generator=g, device=cuda)
    before = (FlowPush.bf16_launches, FlowPush.wide_bf16_launches)
    with pytest.raises(ValueError, match="hidden"):
        FlowPush("bfloat16").run(f, z)
    assert (FlowPush.bf16_launches, FlowPush.wide_bf16_launches) == before


# ------------------ the shapes past the static kernels (chip_smoke phase 13)
# K7 and K7-bf16 at (dim, hidden, layers) the weight-resident kernels do not
# take, or take only through a padded width
SHAPE_FLOWS = [(2, 100, 4), (2, 8, 4), (20, 128, 4), (33, 256, 4),
               (64, 512, 2)]


@pytest.mark.parametrize("N", [8192, 8209])
@pytest.mark.parametrize("d,H,L", SHAPE_FLOWS)
def test_flow_kernels_at_lifted_shapes(cuda, d, H, L, N):
    """K7 within 3e-6 of the plain float32 flow (chip_smoke's
    FLOW_SPLIT_TOL), K7-bf16 within BF16_MAX_TOL of the plain bf16 flow, or
    within 4 times the plain flow's own distance under another order where
    that is larger (the share over every shape's rows together:
    ``test_flow_bf16_share_over_lifted_shapes``), push and pull, each launch
    counted on the variant that takes the shape."""
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush
    from glabc_tpu_torch.ops.kernels.flow_kernel import kernel_variant

    torch.backends.cuda.matmul.allow_tf32 = False
    wide = kernel_variant(d, H) == "wide"
    f, g = _flow_on(cuda, d, L=L, H=H, seed=1000 * d + H)
    z = torch.randn((d, N), generator=g, device=cuda)
    for cls in (FlowPush, FlowPull):
        attr = "wide_launches" if wide else "launches"
        before = getattr(cls, attr)
        got = cls().run(f, z)
        assert getattr(cls, attr) == before + 1
        want = cls().plain(f, z)
        attr = "wide_bf16_launches" if wide else "bf16_launches"
        before = getattr(cls, attr)
        got16 = cls("bfloat16").run(f, z)
        assert getattr(cls, attr) == before + 1
        want16 = cls("bfloat16").plain(f, z)
        torch.cuda.synchronize()
        assert all(torch.isfinite(a).all() for a in (*got, *got16))
        err = max(((a - b).abs() / b.abs().clamp_min(1.0)).max().item()
                  for a, b in zip(got, want))
        assert err <= 3e-6, (cls.__name__, err)
        diff = _row_diff(got16, want16)
        ctl = _row_diff(_smoke().bf16_order_control(f, z, cls.inverse),
                        want16)
        limit = max(BF16_MAX_TOL, 4.0 * ctl.max().item())
        assert diff.max() <= limit, (cls.__name__, diff.max(), limit)


def _smoke():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


def test_flow_bf16_share_over_lifted_shapes(cuda):
    """Over the rows of every lifted shape (both row counts, push and
    pull), the share of rows that differ from the plain bf16 flow by more
    than BF16_ROW_TOL is at most BF16_SHARE, or twice the share by which
    the plain flow differs from itself summed in slices of 32
    (``chip_smoke.bf16_order_control``) where that is larger: at dim 64 x
    512 units no order meets BF16_SHARE (chip_smoke.py gives the
    numbers)."""
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = bad = ctl_bad = 0
    for d, H, L in SHAPE_FLOWS:
        f, g = _flow_on(cuda, d, L=L, H=H, seed=1000 * d + H)
        for N in (8192, 8209):
            z = torch.randn((d, N), generator=g, device=cuda)
            for cls in (FlowPush, FlowPull):
                want = cls("bfloat16").plain(f, z)
                diff = _row_diff(cls("bfloat16").run(f, z), want)
                ctl = _row_diff(_smoke().bf16_order_control(f, z,
                                                            cls.inverse),
                                want)
                rows += diff.numel()
                bad += int((diff > BF16_ROW_TOL).sum())
                ctl_bad += int((ctl > BF16_ROW_TOL).sum())
    assert bad <= max(BF16_SHARE * rows, 2.0 * ctl_bad), (bad, ctl_bad, rows)


@pytest.mark.parametrize("d,H", [(2, 100), (2, 8), (20, 128), (33, 256),
                                 (64, 512), (18, 1), (3, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flow_fragments_on_integers_at_lifted_shapes(cuda, d, H, dtype):
    """An integer-valued layer at the lifted shapes: every product and sum
    is exact, so the log-scale sums equal the plain version's bit for bit
    wherever the kernel puts every weight in its place."""
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush

    torch.backends.cuda.matmul.allow_tf32 = False
    f, z = _integer_flow(cuda, d, H, seed=d * H)
    for cls in (FlowPush, FlowPull):
        got = cls(dtype).run(f, z)
        want = cls(dtype).plain(f, z)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), cls.__name__
        assert torch.allclose(got[0], want[0], rtol=1e-6, atol=0)


@pytest.mark.parametrize("d", [33, 64, 128])
def test_pool_isir_wide_matches_plain_bitwise(cuda, d):
    from glabc_tpu_torch.ops.kernels import PoolISIR

    T, B, C = 16, 5, 2000
    pt, pw, g = _pool_inputs(cuda, T, B, d, C, seed=d)
    th = torch.randn((d, C), generator=g, device=cuda)
    lw = torch.randn((C,), generator=g, device=cuda) - 4.0
    kern = PoolISIR(d, batch_size=B, steps_per_call=T)
    before = PoolISIR.wide_launches
    got = kern.run(3, pt, pw, th, lw, step0=7)
    assert PoolISIR.wide_launches == before + 1
    want = kern.plain(3, pt, pw, th, lw, step0=7)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [33, 64, 128])
def test_kde_logprob_wide_matches_plain(cuda, d):
    from glabc_tpu_torch.models import KernelDensity

    g = torch.Generator(device=cuda).manual_seed(d)
    C, P = 64, 1000
    X = torch.randn((C, P, d), generator=g, device=cuda)
    w = torch.rand((C, P), generator=g, device=cuda)
    x = torch.randn((C, 700, d), generator=g, device=cuda) * 1.5
    args = (x, *kde_logprob_inputs(KernelDensity.fit(X, w)))
    kern = BatchedMixtureLogProb()
    before = BatchedMixtureLogProb.wide_launches
    got = kern.run(*args)
    assert BatchedMixtureLogProb.wide_launches == before + 1
    want = kern.plain(*args)
    torch.cuda.synchronize()
    err = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
    assert torch.isfinite(got).all() and err <= 1e-4, err


@pytest.mark.parametrize("d", [33, 64, 128])
def test_pool_isir_mixed_wide_matches_plain_bitwise(cuda, d):
    from glabc_tpu_torch.models import KernelDensity

    prob = HighDimMixtureProblem(d)
    T, B, C = 16, 5, 2000
    pt, pw, g = _pool_inputs(cuda, T, B, d, C, seed=d + 1)
    th = torch.randn((d, C), generator=g, device=cuda)
    px = (pt.abs() + 0.2 * torch.randn(pt.shape, generator=g,
                                       device=cuda)).contiguous()
    pk = torch.randn((T, B, C), generator=g, device=cuda) - 1.0
    res = resident_from_kde(KernelDensity.fit(
        torch.randn((1024, d), generator=g, device=cuda) * 1.4))
    y = (th.abs() + 0.2 * torch.randn((d, C), generator=g,
                                      device=cuda)).contiguous()
    logk = prob.log_kernel_of_y(y.T.contiguous())
    kern = PoolISIRMixed(d, prob.y_obs.numpy(), epsilon=prob.epsilon,
                         sigma=prob._noise_std, global_frequency=0.5,
                         batch_size=B, steps_per_call=T)
    a = (res, pt, px, pw, pk, th, y, logk)
    before = PoolISIRMixed.wide_launches
    got = kern.run(5, *a, step0=11)
    assert PoolISIRMixed.wide_launches == before + 1
    want = kern.plain(5, *a, step0=11)
    torch.cuda.synchronize()
    for x, w_ in zip(got, want):
        assert torch.equal(x, w_)
    assert 0 < float(got[4].sum()) and 0 < float(got[5].sum())


# -------------------- the generic kernels over tile programs (K8, K9, K5)
def _program_state(name, cuda, C, seed):
    from glabc_tpu_torch import MA2Problem, mixture_tile_program

    prob = MixtureProblem(0.05) if name == "mixture" else MA2Problem()
    prog = (mixture_tile_program(prob) if name == "mixture"
            else prob.tile_program())
    g = torch.Generator(device=cuda).manual_seed(seed)
    scale = 1.3 if name == "mixture" else 0.3
    th = ((torch.rand((2, C), generator=g, device=cuda) - 0.5)
          * scale).contiguous()
    y = prob.simulate(th.T.contiguous(), g).T.contiguous()
    logk = prob.log_kernel_of_y(y.T).contiguous()
    return prob, prog, th, y, logk, g


def _share_differing(got, want, C):
    bad = torch.zeros(C, dtype=torch.bool, device=got[0].device)
    for a, b in zip(got, want):
        if a is None:
            continue
        assert torch.isfinite(a).all()
        bad |= ((a - b).abs() > 1e-5).reshape(-1, C).any(0)
    return bad.float().mean().item()


@pytest.mark.parametrize("name", ["mixture", "ma2"])
@pytest.mark.parametrize("algorithm", ["glmcmc", "global"])
def test_generic_glmcmc_matches_plain(cuda, name, algorithm):
    """K8 against its plain version on one Philox stream."""
    from glabc_tpu_torch.ops.kernels import GenericFusedGLMCMC

    T, C = 16, 2048
    prob, prog, th, y, logk, _ = _program_state(name, cuda, C, 1)
    kern = GenericFusedGLMCMC(prog, global_frequency=0.8, batch_size=5,
                              steps_per_call=T, block_chains=128,
                              algorithm=algorithm)
    before = GenericFusedGLMCMC.launches
    got = kern.run(7, th, y, logk, step0=96)
    assert GenericFusedGLMCMC.launches == before + 1
    want = kern.plain(7, th, y, logk, step0=96)
    torch.cuda.synchronize()
    assert _share_differing([*got[:4], *got[4]], [*want[:4], *want[4]],
                            C) <= 1e-3
    assert torch.equal(got[3][0], want[3][0])
    assert 0 < got[4].accepted.sum().item() < C * T


@pytest.mark.parametrize("B", [1, 5, 64])
@pytest.mark.parametrize("gf", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("algorithm", ["glmcmc", "global"])
@pytest.mark.parametrize("name", ["mixture", "ma2"])
def test_generic_glmcmc_bitwise_at_every_coin_share(cuda, name, algorithm,
                                                    gf, B):
    """K8's one loop of candidate rounds (a global lane's B candidates and
    a local lane's proposal in round 0 of the same loop) on all-local,
    mixed and all-global warps: chains, history and counters bit for bit
    equal to the plain version's, on 1,000 chains (a ragged last warp)."""
    from glabc_tpu_torch.ops.kernels import GenericFusedGLMCMC

    T, C = (4 if B == 64 else 8), 1000
    prob, prog, th, y, logk, _ = _program_state(name, cuda, C, B + 3)
    kern = GenericFusedGLMCMC(prog, global_frequency=gf, batch_size=B,
                              steps_per_call=T, algorithm=algorithm)
    got = kern.run(13, th, y, logk, step0=40)
    want = kern.plain(13, th, y, logk, step0=40)
    torch.cuda.synchronize()
    for a, b in zip([*got[:4], *got[4]], [*want[:4], *want[4]]):
        assert torch.equal(a, b)
    share = got[4].global_attempts.sum().item() / (C * T)
    assert share == gf if gf in (0.0, 1.0) else abs(share - gf) < 0.05


@pytest.mark.parametrize("name", ["mixture", "ma2"])
@pytest.mark.parametrize("coin_mode", ["shared", "per_chain"])
def test_generic_glmala_matches_plain(cuda, name, coin_mode):
    """K9 against its plain version on one Philox stream."""
    from glabc_tpu_torch.ops.kernels import GenericFusedGLMALA

    T, C = 6, 1024
    prob, prog, th, y, logk, g = _program_state(name, cuda, C, 2)
    grad = torch.randn((2, C), generator=g, device=cuda)
    kern = GenericFusedGLMALA(prog, epsilon=prob.epsilon,
                              global_frequency=0.5, tau=0.1, num_grad=10,
                              steps_per_call=T, block_chains=128,
                              coin_mode=coin_mode)
    coins = torch.tensor([1, 0, 0, 1, 0, 1], dtype=torch.int32)
    before = GenericFusedGLMALA.launches
    got = kern.run(5, th, y, logk, grad, coins, step0=64)
    assert GenericFusedGLMALA.launches == before + 1
    want = kern.plain(5, th, y, logk, grad, coins, step0=64)
    torch.cuda.synchronize()
    assert _share_differing([*got[:5], *got[5]], [*want[:5], *want[5]],
                            C) <= 1e-3
    assert 0 < got[5][3].sum().item()      # local MALA moves are accepted


@pytest.mark.parametrize("block_chains", [32, 256])
@pytest.mark.parametrize("gf", [0.0, 0.5, 0.8, 0.97, 1.0])
@pytest.mark.parametrize("name", ["mixture", "ma2"])
def test_generic_glmala_per_chain_warps(cuda, name, gf, block_chains):
    """K9 with the per-chain coin: all-local warps (one thread per chain),
    mixed warps (the warp-cooperative gradient) and nearly all-global
    ones, on a chain count that is no multiple of 32, against the plain
    version: the same chains, the same counters."""
    from glabc_tpu_torch.ops.kernels import GenericFusedGLMALA

    T, C = 6, 1000
    prob, prog, th, y, logk, g = _program_state(name, cuda, C, 4)
    grad = torch.randn((2, C), generator=g, device=cuda)
    kern = GenericFusedGLMALA(prog, epsilon=prob.epsilon,
                              global_frequency=gf, tau=0.1, num_grad=10,
                              steps_per_call=T, block_chains=block_chains,
                              coin_mode="per_chain")
    got = kern.run(9, th, y, logk, grad, step0=32)
    want = kern.plain(9, th, y, logk, grad, step0=32)
    torch.cuda.synchronize()
    assert _share_differing([*got[:5], *got[5]], [*want[:5], *want[5]],
                            C) <= 1e-3
    for a, b in zip(got[5], want[5]):
        assert torch.equal(a, b)
    g_share = got[5][1].sum().item() / (C * T)
    assert abs(g_share - gf) < 0.05
    if gf < 1.0:
        assert got[5][3].sum().item() > 0   # local MALA moves are accepted


@pytest.mark.parametrize("num_draws", [1, 16, 37, 101])
def test_ma2_series_lengths_match_plain(cuda, num_draws):
    """The MA(2) program draws whole Philox blocks once its cursor is
    block-aligned, with a tail for the last steps: K8 and K9 (per-chain
    coin, mixed warps) on series of other lengths against their plain
    versions."""
    from glabc_tpu_torch import MA2Problem
    from glabc_tpu_torch.ops.kernels import (GenericFusedGLMALA,
                                             GenericFusedGLMCMC)

    prob = MA2Problem(num_draws=num_draws, y_obs=[1.0, 0.4, 0.1])
    prog = prob.tile_program()
    C = 1000
    g = torch.Generator(device=cuda).manual_seed(5)
    th = ((torch.rand((2, C), generator=g, device=cuda) - 0.5)
          * 0.3).contiguous()
    y = prob.simulate(th.T.contiguous(), g).T.contiguous()
    logk = prob.log_kernel_of_y(y.T).contiguous()
    k8 = GenericFusedGLMCMC(prog, global_frequency=0.8, batch_size=5,
                            steps_per_call=8, block_chains=128)
    got, want = k8.run(2, th, y, logk, step0=8), k8.plain(2, th, y, logk,
                                                        step0=8)
    torch.cuda.synchronize()
    assert _share_differing([*got[:4], *got[4]], [*want[:4], *want[4]],
                            C) <= 1e-3
    grad = torch.randn((2, C), generator=g, device=cuda)
    k9 = GenericFusedGLMALA(prog, epsilon=prob.epsilon, global_frequency=0.5,
                            tau=0.1, num_grad=6, steps_per_call=4,
                            coin_mode="per_chain")
    got = k9.run(4, th, y, logk, grad, step0=16)
    want = k9.plain(4, th, y, logk, grad, step0=16)
    torch.cuda.synchronize()
    assert _share_differing([*got[:5], *got[5]], [*want[:5], *want[5]],
                            C) <= 1e-3
    for a, b in zip(got[5], want[5]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["mixture", "ma2"])
def test_pool_isir_mixed_program_matches_plain(cuda, name):
    """K5: the program variant (MA(2)) and the built-in Mixture move against
    their plain versions; each counts its own launches."""
    from glabc_tpu_torch.models.kde import KernelDensity

    T, B, C = 16, 5, 2048
    prob, prog, th, y, logk, g = _program_state(name, cuda, C, 3)
    ptheta = ((torch.rand((T, B, 2, C), generator=g, device=cuda) - 0.5)
              * 0.6)
    px = prob.simulate(ptheta.permute(0, 1, 3, 2).contiguous(),
                       g).permute(0, 1, 3, 2).contiguous()
    plogk = prob.log_kernel_of_y(px.permute(0, 1, 3, 2)).contiguous()
    plogw = (plogk + torch.randn(plogk.shape, generator=g,
                                 device=cuda)).contiguous()
    res = resident_from_kde(KernelDensity.fit(
        torch.randn((256, 2), generator=g, device=cuda) * 0.3))
    if name == "ma2":
        kern = PoolISIRMixed(2, program=prog, global_frequency=0.5,
                             batch_size=B, steps_per_call=T,
                             block_chains=128)
        attr = "program_launches"
    else:
        kern = PoolISIRMixed(2, prob.y_obs.numpy(), epsilon=prob.epsilon,
                             sigma=prob._noise_std, global_frequency=0.5,
                             batch_size=B, steps_per_call=T,
                             block_chains=128)
        attr = "launches"
    before = getattr(PoolISIRMixed, attr)
    a = (res, ptheta, px, plogw, plogk, th, y, logk)
    got = kern.run(3, *a, step0=400)
    assert getattr(PoolISIRMixed, attr) == before + 1
    want = kern.plain(3, *a, step0=400)
    torch.cuda.synchronize()
    assert _share_differing(got, want, C) <= 1e-3
    assert abs(got[3].mean().item() / T - 0.5) < 0.05
    assert got[5].sum().item() > 0


def test_program_builds_are_keyed_by_content(cuda):
    """A (kernel, program) pair builds once: a second load reuses the
    library; another program's header builds its own."""
    import os

    from glabc_tpu_torch import MA2Problem, mixture_tile_program
    from glabc_tpu_torch.models import HighDimMixtureProblem as HD
    from glabc_tpu_torch.ops.kernels import _build

    ma2 = MA2Problem().tile_program()
    path = _build.lib_path("generic_glmcmc", ma2)
    _build.load_library("generic_glmcmc", ma2)
    stamp = os.stat(path).st_mtime_ns
    _build.build_all()                       # everything present: no nvcc
    assert os.stat(path).st_mtime_ns == stamp
    again = MA2Problem(epsilon=0.3).tile_program(lp_scale=0.2)
    assert _build.lib_path("generic_glmcmc", again) == path
    assert (_build.load_library("generic_glmcmc", again)
            is _build.load_library("generic_glmcmc", ma2))
    mix3 = mixture_tile_program(HD(3))
    lib3 = _build.load_library("generic_glmcmc", mix3)   # built at first use
    assert os.path.exists(_build.lib_path("generic_glmcmc", mix3))
    assert lib3 is not _build.load_library("generic_glmcmc", ma2)


# ---------------------- K4 and K5 as redesigned for the H100 (bitwise K5)
def _mixed_case(name, cuda, C, T, B, S, gf, seed):
    """Inputs of a K5 launch, built-in Mixture move or MA(2) program."""
    from glabc_tpu_torch.models.kde import KernelDensity

    if name == "ma2":
        prob, prog, th, y, logk, g = _program_state(name, cuda, C, seed)
        ptheta = ((torch.rand((T, B, 2, C), generator=g, device=cuda) - 0.5)
                  * 0.6)
        px = prob.simulate(ptheta.permute(0, 1, 3, 2).contiguous(),
                           g).permute(0, 1, 3, 2).contiguous()
        plogk = prob.log_kernel_of_y(px.permute(0, 1, 3, 2)).contiguous()
        plogw = (plogk + torch.randn(plogk.shape, generator=g,
                                     device=cuda)).contiguous()
        scale = 0.3
        kw = dict(program=prog)
    else:
        prob = _problem(2)
        ptheta, plogw, g = _pool_inputs(cuda, T, B, 2, C, seed=seed)
        px = (ptheta.abs() + 0.2 * torch.randn(ptheta.shape, generator=g,
                                               device=cuda)).contiguous()
        plogk = torch.randn((T, B, C), generator=g, device=cuda) - 1.0
        th = torch.randn((2, C), generator=g, device=cuda)
        y = (th.abs() + 0.2 * torch.randn((2, C), generator=g,
                                          device=cuda)).contiguous()
        logk = prob.log_kernel_of_y(y.T.contiguous())
        scale = 1.4
        kw = dict(y_obs=prob.y_obs.numpy(), epsilon=prob.epsilon,
                  sigma=prob._noise_std)
    res = resident_from_kde(KernelDensity.fit(
        torch.randn((S, 2), generator=g, device=cuda) * scale))
    args = (res, ptheta, px, plogw, plogk, th, y, logk)
    make = lambda blk: PoolISIRMixed(2, global_frequency=gf, batch_size=B,
                                     steps_per_call=T, block_chains=blk,
                                     **kw)
    return make, args


@pytest.mark.parametrize("name", ["builtin", "ma2"])
@pytest.mark.parametrize("S", [1024, 100, 37])
@pytest.mark.parametrize("gf", [0.5, 0.9])
@pytest.mark.parametrize("C", [4113, 17011])
def test_pool_isir_mixed_bitwise_at_every_block_size(cuda, name, S, gf, C):
    """K5 (both local moves) equals its plain version to the bit at blocks
    of 32, 64, 256 and 1024 threads and the default chosen from the chain
    count: block_chains does not change the results.  On an H100 4,113
    chains run 16 a warp (the last warp holds one chain beside 31 inert
    lanes) and 17,011 run 32 a warp (the last holds 19)."""
    T, B = 24, 5
    make, args = _mixed_case(name, cuda, C, T, B, S, gf, S + int(10 * gf))
    want = make(None).plain(5, *args, step0=300)
    attr = "program_launches" if name == "ma2" else "launches"
    for blk in (None, 32, 64, 256, 1024):
        before = getattr(PoolISIRMixed, attr)
        got = make(blk).run(5, *args, step0=300)
        assert getattr(PoolISIRMixed, attr) == before + 1
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), blk
    assert float(got[4].sum() + got[5].sum()) > 0      # chains moved
    assert abs(got[3].mean().item() / T - gf) < 0.05


@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("P", [1000, 250, 37])
def test_kde_logprob_ragged_shapes(cuda, d, P):
    """K4 with N not a multiple of a block's 1,024 points (a full and a
    ragged tile) and P not a multiple of the 8-component chunk, to 1e-4
    max(1, |log q|) of its plain version and 1e-3 of
    KernelDensity.log_prob."""
    from glabc_tpu_torch.models.kde import KernelDensity

    C, N = 24, 1500
    g = torch.Generator(device=cuda).manual_seed(d * P + 1)
    X = torch.randn((C, P, d), generator=g, device=cuda)
    w = torch.rand((C, P), generator=g, device=cuda)
    w[:, ::7] = 0.0
    kdes = KernelDensity.fit(X, w)
    x = torch.randn((C, N, d), generator=g, device=cuda) * 1.5
    args = (x, *kde_logprob_inputs(kdes))
    kern = BatchedMixtureLogProb()
    before = BatchedMixtureLogProb.launches
    got = kern.run(*args)
    assert BatchedMixtureLogProb.launches == before + 1
    want = kern.plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() / want.abs().clamp_min(1.0)).max() <= 1e-4
    lp = kdes.log_prob(x)
    assert ((got - lp).abs() / lp.abs().clamp_min(1.0)).max() <= 1e-3


def test_kde_logprob_one_chain_many_points(cuda):
    """K4 with one chain and 2^20 points (1,024 blocks over one support,
    as the shared epoch's density would be), against its plain version."""
    from glabc_tpu_torch.models.kde import KernelDensity

    g = torch.Generator(device=cuda).manual_seed(20)
    kdes = KernelDensity.fit(torch.randn((1, 1024, 2), generator=g,
                                         device=cuda) * 1.4)
    x = torch.randn((1, 1 << 20, 2), generator=g, device=cuda) * 1.4
    args = (x, *kde_logprob_inputs(kdes))
    got = BatchedMixtureLogProb().run(*args)
    want = BatchedMixtureLogProb().plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() / want.abs().clamp_min(1.0)).max() <= 1e-4


# ------------------------- K3 and K6 redesigned: phases, W and block sizes
@pytest.mark.parametrize("C", [1000, 4113, 32768])
@pytest.mark.parametrize("d,B,T", [(2, 5, 45), (1, 1, 16), (3, 7, 33),
                                   (8, 5, 17), (17, 4, 9)])
def test_pool_isir_bitwise_at_every_block_size(cuda, C, d, B, T):
    """K3's two phases equal its plain version to the bit (sel, counts and
    history included) at blocks of 32, 64, 256 and 1024 threads and the
    default from the chain count, on chain counts that are not multiples
    of 32, -inf pool weights and a -inf and a NaN carried weight, with the
    history kept and not."""
    ptheta, plogw, g = _pool_inputs(cuda, T, B, d, C, seed=C + d)
    theta = torch.randn((d, C), generator=g, device=cuda)
    logw = torch.randn((C,), generator=g, device=cuda) - 4.0
    logw[::97] = -float("inf")
    logw[5::101] = float("nan")
    for collect in (True, False):
        make = lambda blk: PoolISIR(d, batch_size=B, steps_per_call=T,
                                    block_chains=blk,
                                    collect_history=collect)
        want = make(None).plain(3, ptheta, plogw, theta, logw, step0=200)
        for blk in (None, 32, 64, 256, 1024):
            before = PoolISIR.launches
            got = make(blk).run(3, ptheta, plogw, theta, logw, step0=200)
            assert PoolISIR.launches == before + 1
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                if b is None:
                    assert a is None
                    continue
                assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)), blk
                assert torch.equal(a.isnan(), b.isnan()), blk
    moves = float(want[3].sum()) / (C * T)
    assert 0.05 < moves < 0.95


def _glmala_case(cuda, d, mode, gf, C, T=6, seed=0):
    from glabc_tpu_torch.ops.kernels import FusedMixtureGLMALA

    prob = _problem(d) if d > 1 else HighDimMixtureProblem(1)
    g = torch.Generator(device=cuda).manual_seed(seed + d)
    theta = (torch.randn((d, C), generator=g, device=cuda) * 1.3).contiguous()
    y = (theta.abs() + 0.2 * torch.randn((d, C), generator=g,
                                         device=cuda)).contiguous()
    logk = prob.log_kernel_of_y(y.T.contiguous()).contiguous()
    grad = torch.randn((d, C), generator=g, device=cuda)
    coins = torch.from_numpy((np.random.default_rng(seed).random(T) < gf)
                             .astype(np.int32))
    def make(blk, w):
        """The kernel at ``blk`` threads a block and, where ``w`` is given,
        ``w`` chains a warp in place of the launch rule's."""
        kern = FusedMixtureGLMALA(
            d, prob.y_obs.numpy(), epsilon=prob.epsilon,
            sigma=prob._noise_std, global_frequency=gf, num_grad=20,
            steps_per_call=T, block_chains=blk, coin_mode=mode)
        if w is not None:
            kern._geometry = lambda C, dev: (blk, w)
        return kern
    return make, (theta, y, logk, grad, coins)


@pytest.mark.parametrize("gf", [0.0, 0.5, 0.8, 1.0])
@pytest.mark.parametrize("coin_mode", ["shared", "per_chain"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_glmala_bitwise_across_warp_shapes(cuda, d, coin_mode, gf):
    """K6 with W in {32, 16, 8, 4} chains a warp and blocks of 32, 128,
    256 and 1024 threads (and the defaults): every output equal to the
    bit across them, and within the limits against the plain version (at
    most 0.1 % of chains over 1e-5, the first step's history within 1e-5),
    on 1,000 chains (a ragged last warp)."""
    C, T = 1000, 6
    make, args = _glmala_case(cuda, d, coin_mode, gf, C, T, seed=int(10 * gf))
    want = make(None, None).plain(5, *args, step0=96)
    ref = make(None, None).run(5, *args, step0=96)
    torch.cuda.synchronize()
    outs, refs = [*ref[:5], *ref[5]], [*want[:5], *want[5]]
    assert _share_differing(outs, refs, C) <= 1e-3
    assert torch.allclose(ref[4][0], want[4][0], rtol=0, atol=1e-5)
    for w in (32, 16, 8, 4):
        for blk in (32, 128, 256, 1024):
            got = make(blk, w).run(5, *args, step0=96)
            torch.cuda.synchronize()
            for a, b in zip([*got[:5], *got[5]], outs):
                assert torch.equal(a, b), (w, blk)
    if coin_mode == "per_chain":
        assert abs(ref[5][1].sum().item() / (C * T) - gf) < 0.05
    if gf < 1.0:
        assert ref[5][3].sum().item() > 0     # local MALA moves are accepted
    if gf > 0.0:
        assert ref[5][2].sum().item() > 0     # and global ones


def test_glmala_default_launch_at_the_main_shape(cuda):
    """32,768 chains, both coin modes: the default geometry (W and the
    block from the chain count and the coin mode: 32 shared, 16 per-chain)
    equals W = 8 at 256 threads to the bit."""
    C, T = 32768, 4
    for mode in ("shared", "per_chain"):
        make, args = _glmala_case(cuda, 2, mode, 0.5, C, T, seed=3)
        a = make(None, None).run(9, *args, step0=0)
        b = make(256, 8).run(9, *args, step0=0)
        torch.cuda.synchronize()
        for x, y in zip([*a[:5], *a[5]], [*b[:5], *b[5]]):
            assert torch.equal(x, y)


# --------------------------------- the chain offset and mesh= (M12) on the card
SPLIT_CASES = 10   # chip_smoke.split_cases: K1, K2, K3, K5 x2, K6 x2, K8, K9 x2


def _split_cases(device, C, T):
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    cases = chip_smoke.split_cases(device, C, T, seed=C)
    assert len(cases) == SPLIT_CASES
    return chip_smoke, cases


@pytest.mark.parametrize("C", [4096, 3000])
@pytest.mark.parametrize("index", range(SPLIT_CASES))
def test_chain_offset_split_launch_is_bitwise(cuda, index, C):
    """Each kernel that draws randomness, launched over C chains and over
    its two halves with chain0 0 and C/2 (each half packed on its own;
    3,000 chains split at 1,500, no multiple of a warp or a block), gives
    the same bits; with chain0 0 for both halves it does not."""
    cs, cases = _split_cases(cuda, C, 16)
    name, run = cases[index]
    same, max_abs = cs.split_matches(run, C)
    torch.cuda.synchronize()
    assert same, (name, max_abs)
    assert not cs.split_matches(run, C, offset=False)[0], name


def test_mesh_world_size_one_is_bitwise(cuda, tmp_path):
    """``run_glmcmc_fused`` with ``mesh=make_mesh()`` over a one-rank NCCL
    group equals the ``mesh=None`` run: history and counts."""
    import torch.distributed as dist
    from glabc_tpu_torch import run_glmcmc_fused
    from glabc_tpu_torch.parallel import initialize_distributed, make_mesh

    prob = MixtureProblem(0.05)
    run = lambda mesh: run_glmcmc_fused(
        prob, torch.Generator(device=cuda).manual_seed(2), 65, np.zeros(2),
        num_chains=8192, steps_per_call=32, mesh=mesh)
    ref = run(None)
    initialize_distributed("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        got = run(make_mesh())
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got.thetas, ref.thetas)
    for a, b in zip(got.counts, ref.counts):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chains", [None, "all"])
def test_native_writer_on_cuda_history(cuda, tmp_path, chains):
    """The native writer under a fused run on the card (K1 launches): with
    ``chains='all'`` the binary file reads back bitwise as the history;
    with ``chains=None`` the chain-0 CSV holds chain 0 (``%.9g`` reads back
    to the same float32)."""
    from glabc_tpu_torch import DiagGaussian, MCMCRunner
    from glabc_tpu_torch.native import native_available
    from glabc_tpu_torch.utils import read_binary_chains

    assert native_available()
    runner = MCMCRunner(MixtureProblem(0.05), output_dir=str(tmp_path),
                        num_chains=4096, verbose=False, write_chains=chains,
                        use_native_io=True)
    before = PackedMixtureGLMCMC.launches
    ch = runner.run_glmcmc(
        129, np.zeros(2), None, 0.9, DiagGaussian.create(2, 0.0, float(np.log(0.35))),
        DiagGaussian.create(2), 5, output_file="h.bin", method="fused",
        steps_per_call=32)
    assert PackedMixtureGLMCMC.launches == before + 4
    if chains == "all":
        got = read_binary_chains(str(tmp_path / "h.bin"))
        np.testing.assert_array_equal(got, ch)
    else:
        got = np.loadtxt(tmp_path / "h.bin", delimiter=",", dtype=np.float32)
        np.testing.assert_array_equal(got, ch[0])


@pytest.mark.parametrize("d,N", [(2, 4099), (3, 1000), (8, 777)])
def test_flow_forward_t_and_log_prob_t_through_k7(cuda, d, N):
    """``forward_t`` and ``log_prob_t`` on the card launch the K7 push and
    pull once each, and agree with the plain flow (``push_t``/``pull_t``)
    on the same base draws to K7's 1e-4 max(1, |x|)."""
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush

    torch.backends.cuda.matmul.allow_tf32 = False
    f, _ = _flow_on(cuda, d, seed=d + N)
    push0, pull0 = FlowPush.launches, FlowPull.launches
    x_t, log_q = f.forward_t(N, torch.Generator(device=cuda).manual_seed(3))
    lq = f.log_prob_t(x_t)
    assert (FlowPush.launches, FlowPull.launches) == (push0 + 1, pull0 + 1)
    g = torch.Generator(device=cuda).manual_seed(3)
    with torch.no_grad():
        eps = torch.randn((N, d), generator=g, device=cuda)
        z = f.loc + torch.exp(f.log_scale) * eps
        x_ref, s_ref = f.push_t(z.T)
        log_q_ref = f.base_log_prob(z) - s_ref
        z_back, s_back = f.pull_t(x_t)
        lq_ref = f.base_log_prob(z_back.T) - s_back
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()
    assert rel(x_t, x_ref) <= 1e-4
    assert rel(log_q, log_q_ref) <= 1e-4
    assert rel(lq, lq_ref) <= 1e-4
    assert rel(lq, log_q) <= 1e-4      # the round trip


@pytest.mark.parametrize("d,attr", [(2, "launches"), (40, "wide_launches")])
def test_shared_epoch_density_through_k4(cuda, d, attr):
    """One shared epoch at 1,024 chains and ``redraw_chunk`` 256 launches
    K4 once a chunk, each with the pool epilogue (4 ``pool_launches``; the
    runtime-d variant at d = 40), and never without it (``attr``, the
    count of that d's kernel without the epilogue), and its pools'
    ``log_q`` is within 1e-4 max(1, |log q|) of K4's plain version on the
    same draws."""
    from glabc_tpu_torch import DiagGaussian
    from glabc_tpu_torch.models.kde import KernelDensity
    from glabc_tpu_torch.samplers import aglmcmc as agl

    prob = _problem(d)
    cfg = agl.AGLMCMCConfig(0.5, 5, 200, 0.8, 0.2, 4, 0, 0)
    g = torch.Generator(device=cuda).manual_seed(19)
    pools = agl._init_pools(prob, g, DiagGaussian.create(d, device=cuda),
                            1024, 1000)
    before = (getattr(BatchedMixtureLogProb, attr),
              BatchedMixtureLogProb.pool_launches)
    new, kde, _ = agl._shared_epoch_update(
        prob, cfg, 1024, g, pools, torch.tensor(1e6, device=cuda),
        redraw_chunk=256)
    assert (getattr(BatchedMixtureLogProb, attr),
            BatchedMixtureLogProb.pool_launches) == (before[0],
                                                     before[1] + 4)
    args = kde_logprob_inputs(KernelDensity(
        kde.X[None], kde.weights[None], kde.bandwidth[None]))
    want = BatchedMixtureLogProb().plain(
        new.theta.reshape(1, -1, d).contiguous(), *args).reshape(1024, -1)
    torch.cuda.synchronize()
    assert torch.isfinite(new.log_q).all()
    assert ((new.log_q - want).abs() / want.abs().clamp_min(1.0)).max() \
        <= 1e-4


def _cuda_kernels(fn):
    """The CUDA kernels ``fn()`` launches (``torch.profiler``'s device
    events, copies excluded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset")))


@pytest.mark.parametrize("d,chunk,P,support", [(2, 512, 2000, 1024),
                                               (40, 64, 200, 1024),
                                               (2, 128, 200, 16384),
                                               (2, 128, 200, 12280),
                                               (2, 128, 200, 12288)])
def test_shared_redraw_bitwise_and_launches(cuda, monkeypatch, d, chunk, P,
                                            support):
    """K10 at the cell's chunk shape (512 chains x P = 2,000, d = 2; at
    d = 40, where no candidate passes the prior's cutoff and the fill pass
    places every row, through the runtime-d kernel and K4's wide pool
    epilogue; on 12,280 support points, the most whose CDF K10 stages in
    shared memory beside its static counts, and on 12,288 and 16,384,
    whose CDF it searches in device memory): theta and x bitwise
    its plain version on the card, dis and
    prior + log K within 1e-6 max(1, |v|).  The epoch's chunk path against
    the sequence K10 replaced (``_redraw``, K4, ``_pool_from_proposals``,
    the generic path) on the same generator: theta and x bitwise, dis,
    log q and log w within 1e-6 max(1, |v|).  A chunk launches at most 6
    kernels (three draws, K10, K4), the replaced sequence more."""
    from glabc_tpu_torch import DiagGaussian
    from glabc_tpu_torch.models.kde import KernelDensity
    from glabc_tpu_torch.ops.kernels.shared_redraw_kernel import SharedRedraw
    from glabc_tpu_torch.samplers import aglmcmc as agl

    prob = _problem(d)
    cfg = agl.AGLMCMCConfig(0.5, 5, P // 5, 0.8, 0.2, 4, 0, 0)
    g = torch.Generator(device=cuda).manual_seed(23)
    pools = agl._init_pools(prob, g, DiagGaussian.create(d, device=cuda),
                            chunk, P)
    kde = KernelDensity.fit(pools.theta.reshape(-1, d)[:support])
    inputs = agl._redraw_inputs(prob, kde)
    assert kde.n_samples == support and inputs is not None
    M = cfg.oversample * P
    u = torch.rand((chunk, M), generator=g, device=cuda)
    z = torch.randn((chunk, M, d), generator=g, device=cuda)
    noise = torch.randn((chunk, P, d), generator=g, device=cuda)
    before = SharedRedraw.launches
    got = SharedRedraw().run(u, z, noise, inputs)
    assert SharedRedraw.launches == before + 1
    want = SharedRedraw().plain(u, z, noise, inputs)
    torch.cuda.synchronize()
    rel = lambda a, b: float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert rel(got[2], want[2]) <= 1e-6 and rel(got[3], want[3]) <= 1e-6

    def chunks(n, generic=False):
        if generic:
            monkeypatch.setattr(agl, "_redraw_inputs",
                                lambda *a: None)
        gen = torch.Generator(device=cuda).manual_seed(29)
        out = agl._redraw_chunks(prob, cfg, gen, kde, n * chunk, P, chunk)
        monkeypatch.undo()
        return out

    new, old = chunks(1), chunks(1, generic=True)
    torch.cuda.synchronize()
    assert torch.equal(new.theta, old.theta) and torch.equal(new.x, old.x)
    for a, b in ((new.dis, old.dis), (new.log_q, old.log_q),
                 (new.log_w, old.log_w)):
        assert bool(torch.isfinite(a).all()) or d == 40
        fin = torch.isfinite(b)
        assert torch.equal(fin, torch.isfinite(a))
        assert rel(a[fin], b[fin]) <= 1e-6
    per_chunk = [_cuda_kernels(lambda: chunks(2, generic))
                 - _cuda_kernels(lambda: chunks(1, generic))
                 for generic in (False, True)]
    print(f"kernels a chunk: K10 path {per_chunk[0]}, replaced sequence "
          f"{per_chunk[1]}")
    assert per_chunk[0] <= 6 < per_chunk[1]


def _radix_input(name, device):
    """The mesh cell's shard of pool discrepancies in size (32,768,000
    positive values, 1 % at the NaN rows' sentinel), or small arrays with
    bulk ties, NaN, inf and signed zeros."""
    from glabc_tpu_torch.samplers.aglmcmc import _NAN_DIS

    g = torch.Generator(device=device).manual_seed(11)
    if name == "cell":
        x = torch.randn(32_768_000, generator=g, device=device).abs()
        x[::100] = _NAN_DIS
        return x
    x = torch.randn(4099, generator=g, device=device)
    if name == "ties":
        x[::2] = _NAN_DIS
        x[1::4] = 0.25
    else:
        x[::5] = float("nan")
        x[1::7] = float("inf")
        x[2::9] = -0.0
        x[3::9] = 0.0
    return x


@pytest.mark.parametrize("name", ["cell", "ties", "nan"])
def test_radix_select_bitwise_and_launches(cuda, name):
    """K11 against its plain versions, bitwise, on every pass of selects at
    ranks whose prefixes agree and differ: the histograms, and the state
    and values each pick writes (``chip_smoke.radix_select_checked``, which
    patches ``RadixSelect.hist`` and ``pick`` for the select); the select's
    values against ``torch.sort``'s order statistics (as keys: a zero's sign
    and a NaN's payload aside, bitwise); a select launches one histogram
    and one pick a pass."""
    from glabc_tpu_torch.ops.kernels.radix_select_kernel import (
        DIGITS, RadixSelect, order_keys)

    x = _radix_input(name, cuda)
    n = x.numel()
    xs = torch.sort(x).values
    ranks = [(0, 0), (n // 2, n // 2 + 1), (n // 10, n - 1), (n - 2, n - 1),
             (1, n // 3)]
    for k in ranks:
        k = torch.tensor(k, device=cuda)
        before = (RadixSelect.launches, RadixSelect.pick_launches)
        got, checks = _smoke().radix_select_checked(x, k)
        assert [c[:2] for c in checks] == [
            (step, b) for b in DIGITS for step in ("hist", "pick")]
        assert all(c[2] for c in checks), (k, checks)
        assert (RadixSelect.launches, RadixSelect.pick_launches) == (
            before[0] + len(DIGITS), before[1] + len(DIGITS))
        assert torch.equal(order_keys(got), order_keys(xs[k])), k


def test_mesh_select_makes_no_host_sync(cuda, tmp_path):
    """``distributed_quantile`` (K11) and ``distributed_systematic_resample``
    on a one-rank NCCL group raise nothing under
    ``torch.cuda.set_sync_debug_mode("error")``, and equal the one-device
    ``quantile`` and ``systematic_resample``."""
    import torch.distributed as dist
    from glabc_tpu_torch.ops.resampling import systematic_resample
    from glabc_tpu_torch.parallel import (distributed_quantile,
                                          distributed_systematic_resample,
                                          initialize_distributed, make_mesh)
    from glabc_tpu_torch.samplers.aglmcmc import quantile

    x = _radix_input("ties", cuda)
    w = torch.rand(1 << 16, dtype=torch.float64, device=cuda)
    q = torch.tensor(0.3, device=cuda)
    gen = lambda: torch.Generator(device=cuda).manual_seed(4)
    initialize_distributed("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh()
        select = lambda: (distributed_quantile(x, q, mesh),
                          distributed_systematic_resample(
                              w, 1024, mesh, gen(), replicated=True))
        select()                      # the communicator, the library
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got_q, got_i = select()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got_q, quantile(x, q))
    assert torch.equal(got_i, systematic_resample(w / w.sum(), 1024, gen()))
