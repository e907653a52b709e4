"""The plain reference at tiny sizes: the posterior its GLMCMC reaches, and
the epoch's pieces against their definitions."""

import math

import numpy as np
import pytest
import torch

from perfbench.reference import aglmcmc as ref
from perfbench.reference.glmcmc import Moves, replay
from perfbench.reference.mixture import Problem

PB = Problem.create(2, [1.5, 1.5], 0.05, 0.05)


def exact_abs_mean():
    """E|theta_k| of the ABC posterior: per dim N(theta; 0, 1) N(1.5;
    |theta|, noise_var + epsilon^2), by quadrature."""
    th = np.linspace(-6, 6, 200001)
    s2 = 0.05 + 0.05 ** 2
    p = np.exp(-0.5 * th ** 2 - 0.5 * (1.5 - np.abs(th)) ** 2 / s2)
    return float(np.sum(np.abs(th) * p) / np.sum(p))


def test_glmcmc_reaches_the_posterior():
    R = 4096
    mv = Moves.create(5, 0.9, 0.35)
    th, y, lk, (ga, gacc, lacc) = replay(
        PB, mv, torch.full((R,), 12345, dtype=torch.int64),
        torch.arange(R), torch.zeros(R, 2),
        torch.abs(torch.zeros(R, 2)) + math.sqrt(0.05) * torch.randn(
            R, 2, generator=torch.Generator().manual_seed(0)), 200)
    m = th.abs().mean(dim=0).double()
    sd = th.abs().std(dim=0).double() / math.sqrt(R)
    assert torch.all((m - exact_abs_mean()).abs() < 4 * sd), (m, sd)
    assert torch.all(ga + (200 - ga) == 200)
    assert 0.85 < float(ga.sum()) / (200 * R) < 0.95
    assert torch.all(gacc <= ga) and torch.all(lacc <= 200 - ga)
    want = ref.kernel_log_prob(ref.torch.sqrt(((y - 1.5) ** 2).sum(-1)),
                               0.05)
    assert torch.allclose(lk, want, atol=1e-4)


def test_replay_rows_are_independent():
    """A row's chain does not depend on which other rows step with it."""
    mv = Moves.create(5, 0.5, 0.35)
    y0 = torch.rand(8, 2) + 1.0
    seeds = torch.tensor([1, 2, 3, 4, 5, 6, 7, 2**40 + 9])
    full = replay(PB, mv, seeds, torch.arange(8), torch.zeros(8, 2), y0, 20)
    part = replay(PB, mv, seeds[5:], torch.arange(5, 8), torch.zeros(3, 2),
                  y0[5:], 20)
    assert torch.equal(full[0][5:], part[0])


def test_anneal_is_the_quantile_rule():
    dis = torch.rand(10001, generator=torch.Generator().manual_seed(1))
    e = ref.anneal(dis, 1e6, 0.8, 0.2)
    assert e == pytest.approx(float(np.quantile(dis.double().numpy(), 0.8)))
    e2 = ref.anneal(dis, 0.5, 0.8, 0.2)
    q = 0.8 * float((dis < 0.5).sum()) / dis.numel()
    assert e2 == pytest.approx(float(np.quantile(dis.double().numpy(), q)))
    assert ref.anneal(dis, 0.2, 0.8, 0.2) == 0.2
    assert ref.anneal(dis * 0.01, 0.5, 0.8, 0.2) == 0.2


def test_systematic_resample_passes_and_a_changed_one_fails():
    g = torch.Generator().manual_seed(3)
    theta = torch.randn(5000, 2, generator=g)
    w = torch.rand(5000, generator=g, dtype=torch.float64) ** 8
    w = w / w.sum()
    X = theta[ref.systematic(w, 1024, 0.37)]
    assert ref.support_bad_share(theta, w, X) == 0.0
    assert ref.support_bad_share(theta, w, X + 1e-3) >= 1.0
    X2 = X.clone()
    X2[:512] = X[0]                       # one row taken 512 times
    assert ref.support_bad_share(theta, w, X2) > 0.4


def test_silverman_and_kde_density():
    g = torch.Generator().manual_seed(4)
    X = torch.randn(1024, 2, generator=g)
    h = ref.silverman(X)
    std = X.double().std(dim=0)
    assert torch.allclose(h, std * (1024 * 4 / 4.0) ** (-1 / 6), rtol=1e-6)
    # the density integrates to 1 (up to the 1e-10 stabiliser)
    t = torch.linspace(-7, 7, 561)
    grid = torch.stack(torch.meshgrid(t, t, indexing="ij"), -1).reshape(-1, 2)
    lq = ref.kde_log_q(grid, X, h)
    mass = float(torch.exp(lq).sum()) * float(t[1] - t[0]) ** 2
    assert mass == pytest.approx(1.0, abs=1e-3)
    # the resident form is the same density in float32
    rq = ref.resident_log_q(X, h.float(), grid[:4096].float())
    assert torch.allclose(rq.double(), lq[:4096], atol=2e-4)


def test_widest_gap():
    a = torch.tensor([1.0, -float("inf"), 100.0])
    assert ref.widest_gap(a, a.clone()) == 0.0
    assert ref.widest_gap(a + torch.tensor([0.0, 0.0, 1.0]), a) == \
        pytest.approx(0.01)
    assert ref.widest_gap(torch.tensor([1.0, 2.0, float("nan")]),
                          torch.tensor([1.0, 2.0, 3.0])) == math.inf
