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
from glabc_tpu_torch.ops.kernels import (FusedMixtureGLMCMC,
                                         PackedMixtureGLMCMC,
                                         fused_state_init, packed_state_init)
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
