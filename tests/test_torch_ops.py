"""glabc_tpu_torch.ops (statistics, resampling) held against glabc_tpu.ops.

Deterministic functions get the same numpy inputs and must agree at rtol
1e-5 (float32 reductions in another order).  The sampling functions draw
from a torch.Generator, so they are checked by distribution: a chi-square
test on 1e5 draws at the 0.999 quantile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from glabc_tpu.ops import resampling as jres
from glabc_tpu.ops import stats as jstats
from glabc_tpu_torch.ops import resampling as tres
from glabc_tpu_torch.ops import stats as tstats

torch.set_num_threads(1)

RTOL = 1e-5


def _chains(seed, C=4, N=400, d=2):
    """AR(1) chains with a per-chain offset: autocorrelated like MCMC output
    and with repeated values, as rejected moves give."""
    rng = np.random.default_rng(seed)
    x = np.zeros((C, N, d))
    for t in range(1, N):
        x[:, t] = 0.8 * x[:, t - 1] + rng.normal(size=(C, d))
    x += rng.normal(0, 0.3, (C, 1, d))
    x[:, 1::7] = x[:, 0::7][:, :x[:, 1::7].shape[1]]
    return x.astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("shape", [(400, 2), (3, 300, 3)])
def test_esjd(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    x = np.cumsum(x, axis=-2) * 0.1
    np.testing.assert_allclose(_np(tstats.esjd(torch.from_numpy(x))),
                               np.asarray(jstats.esjd(jnp.asarray(x))),
                               rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_ess(seed):
    x = _chains(seed)
    np.testing.assert_allclose(_np(tstats.ess(x)),
                               np.asarray(jstats.ess(jnp.asarray(x))),
                               rtol=RTOL)


def test_rhat():
    x = _chains(2)
    np.testing.assert_allclose(_np(tstats.rhat(x)), np.asarray(jstats.rhat(x)),
                               rtol=RTOL)
    with pytest.raises(ValueError):
        tstats.rhat(x[:1])


@pytest.mark.parametrize("unbiased", [True, False])
def test_weighted_std(unbiased):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(200, 3)).astype(np.float32)
    w = rng.uniform(0, 1, 200).astype(np.float32)
    np.testing.assert_allclose(
        _np(tstats.weighted_std(torch.from_numpy(x), torch.from_numpy(w),
                                unbiased=unbiased)),
        np.asarray(jstats.weighted_std(jnp.asarray(x), jnp.asarray(w),
                                       unbiased=unbiased)),
        rtol=RTOL)


def test_chain_summary():
    x = _chains(4)
    ref = jstats.chain_summary(jnp.asarray(x), acceptance_rate=0.25,
                               with_esjd=True, with_ess=True, with_rhat=True)
    port = tstats.chain_summary(x, acceptance_rate=0.25, with_esjd=True,
                                with_ess=True, with_rhat=True)
    for field in ("mean", "variance", "ci_lower", "ci_upper", "esjd", "ess",
                  "rhat"):
        np.testing.assert_allclose(_np(getattr(port, field)),
                                   np.asarray(getattr(ref, field)),
                                   rtol=RTOL, atol=1e-6, err_msg=field)
    assert port.render().splitlines()[0] == ref.render().splitlines()[0]
    assert len(port.render().splitlines()) == len(ref.render().splitlines())


def test_sanitize_log_weights():
    lw = np.array([[0.5, np.nan, -np.inf, -3.0], [np.nan, np.nan, 1.0, 2.0]],
                  np.float32)
    np.testing.assert_array_equal(
        _np(tres.sanitize_log_weights(torch.from_numpy(lw))),
        np.asarray(jres.sanitize_log_weights(jnp.asarray(lw))))


def test_categorical_from_log_weights_chi_square():
    w = np.array([0.05, 0.1, 0.15, 0.2, 0.5, 0.0], np.float64)
    n = 100_000
    log_w = np.log(np.where(w > 0, w, 1.0)) + np.where(w > 0, 0.0, -np.inf)
    log_w = np.broadcast_to(log_w.astype(np.float32) + 3.0, (n, w.size))
    g = torch.Generator().manual_seed(0)
    idx = _np(tres.categorical_from_log_weights(
        torch.from_numpy(log_w.copy()), g))
    counts = np.bincount(idx, minlength=w.size)
    assert counts[-1] == 0                      # zero weight never drawn
    exp = n * w[:-1]
    stat = float(np.sum((counts[:-1] - exp) ** 2 / exp))
    assert stat < chi2.ppf(0.999, w.size - 2), (stat, counts)


def test_categorical_nan_and_all_zero_rows():
    g = torch.Generator().manual_seed(1)
    lw = torch.tensor([[np.nan, 0.0, np.nan], [-np.inf, -np.inf, -np.inf]])
    idx = _np(tres.categorical_from_log_weights(lw, g))
    assert idx[0] == 1     # NaN is zero mass
    assert idx[1] == 0     # every weight zero: the "stay" slot


def test_systematic_resample_counts():
    """Systematic resampling of 1e5 draws: each index appears floor or ceil
    of ``N w_j`` times, and the chi-square statistic is far inside its
    0.999 quantile."""
    w = np.array([0.05, 0.1, 0.15, 0.2, 0.5], np.float32)
    n = 100_000
    g = torch.Generator().manual_seed(2)
    idx = _np(tres.systematic_resample(torch.from_numpy(w), n, g))
    assert idx.shape == (n,)
    counts = np.bincount(idx, minlength=w.size)
    exp = n * w.astype(np.float64)
    assert np.all(np.abs(counts - exp) <= 1.5), counts
    stat = float(np.sum((counts - exp) ** 2 / exp))
    assert stat < chi2.ppf(0.999, w.size - 1)
    # NaN and negative weights are zero mass
    w_bad = torch.tensor([np.nan, 0.5, -1.0, 0.5])
    idx = _np(tres.systematic_resample(w_bad, 1000, g))
    assert set(np.unique(idx)) <= {1, 3}
