"""The torch Philox4x32-10 (the plain twin of ``csrc/philox.cuh``) and the
variates built on it.

Known-answer vectors are Random123's Philox4x32-10 test vectors
(``kat_vectors``), written out here.  The uniform mapping is the TPU
kernels' (top 24 bits, ``(bits >> 8) 2^-24 + 2^-25``), which must stay
strictly inside (0, 1).
"""

import math

import numpy as np
import pytest
import torch

from glabc_tpu_torch.ops.kernels.mixture_kernel import MixtureConfig, draw_noise
from glabc_tpu_torch.ops.kernels.philox import (gumbel, normal_pair,
                                                philox4x32, seed_key,
                                                uniform_from_bits)

torch.set_num_threads(1)

# (counter words, key words, expected output words)
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    out = philox4x32(*(torch.tensor([c]) for c in ctr), *key)
    assert [int(w[0]) for w in out] == list(want)


def test_philox_vectorised_matches_scalar_calls():
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2**32, (64, 4), dtype=np.uint64).astype(np.int64)
    k0, k1 = 0x12345678, 0x9ABCDEF0
    batch = torch.stack(philox4x32(*(torch.from_numpy(ctr[:, i])
                                     for i in range(4)), k0, k1), dim=1)
    for row in (0, 17, 63):
        one = philox4x32(*(torch.tensor([int(v)]) for v in ctr[row]), k0, k1)
        assert [int(w[0]) for w in one] == batch[row].tolist()
    assert int(batch.min()) >= 0 and int(batch.max()) < 2**32


def test_seed_key():
    assert seed_key(0) == (0, 0)
    assert seed_key(2**32 + 5) == (5, 1)
    with pytest.raises(ValueError):
        seed_key(-1)


def test_uniform_open_interval():
    """``u`` lies strictly in (0, 1) at both ends of the bit range, so
    ``log u`` and the Gumbel never see 0 or 1."""
    bits = torch.tensor([0, 255, 256, 0xFFFFFF00, 0xFFFFFFFF],
                        dtype=torch.int64)
    u = uniform_from_bits(bits)
    assert u.dtype == torch.float32
    assert float(u[0]) == 2.0 ** -25
    assert float(u[1]) == 2.0 ** -25           # the low 8 bits are dropped
    assert float(u.max()) < 1.0 and float(u.min()) > 0.0
    assert torch.isfinite(gumbel(u)).all()
    n1, n2 = normal_pair(u, u)
    assert torch.isfinite(n1).all() and torch.isfinite(n2).all()


def test_uniform_and_normal_moments():
    """2^17 Philox blocks -> uniforms with mean 1/2 and variance 1/12, and
    Box-Muller pairs that are standard normal and uncorrelated (5 standard
    errors)."""
    n = 2**17
    words = philox4x32(torch.arange(n), 7, 0, 0, *seed_key(12345))
    u = torch.stack([uniform_from_bits(w) for w in words], dim=1)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    uf = u.double()
    se = 1.0 / math.sqrt(12 * uf.numel())
    assert abs(float(uf.mean()) - 0.5) < 5 * se
    assert abs(float(uf.var()) - 1 / 12) < 0.002
    n1, n2 = normal_pair(u[:, 0], u[:, 1])
    z = torch.stack([n1, n2], 1).double()
    se = 1.0 / math.sqrt(n)
    assert torch.all(z.mean(0).abs() < 5 * se)
    assert torch.all((z.var(0) - 1).abs() < 5 * math.sqrt(2 / n))
    corr = float(torch.corrcoef(z.T)[0, 1])
    assert abs(corr) < 5 * se
    g = gumbel(u[:, 2]).double()
    assert abs(float(g.mean()) - 0.5772156649) < 5 * (math.pi / math.sqrt(6 * n))


def test_draw_noise_layout():
    """One GLMCMC transition at d=2, B=5 uses 8 Philox blocks (32
    uniforms); a chain's draws depend only on (seed, chain, step)."""
    cfg = MixtureConfig.create(2, [1.5, 1.5], epsilon=0.05, sigma=0.2236,
                               global_frequency=0.9, batch_size=5,
                               prior_loc=0.0, prior_scale=1.0, ip_loc=0.0,
                               ip_scale=1.0, lp_scale=0.35,
                               algorithm="glmcmc")
    assert cfg.blocks_per_step == 8
    a = draw_noise(3, torch.arange(10, 20), 5, cfg)
    b = draw_noise(3, torch.arange(0, 40), 5, cfg)
    for x, y in zip(a, b):
        if x is not None:   # u_global is drawn by 'global' only
            torch.testing.assert_close(x, y[10:20], rtol=0, atol=0)
    c = draw_noise(3, torch.arange(10, 20), 6, cfg)
    assert not torch.equal(a.u_coin, c.u_coin)
    assert a.gumbel.shape == (10, 6) and a.n1.shape == (10, 5, 2)
