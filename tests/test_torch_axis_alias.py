"""``axis=``, the JAX package's keyword, as an alias of the port's ``dim=``.

``weighted_std`` and ``categorical_from_log_weights`` take either keyword
(not both).  Each ``axis=`` call equals the ``dim=`` call, and matches the
JAX function on the same numpy inputs: ``weighted_std`` at rtol 1e-5
(float32 reductions in another order), the categorical exactly on rows
where one entry holds all the mass, so that both Gumbel streams pick it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glabc_tpu.ops import resampling as jres
from glabc_tpu.ops import stats as jstats
from glabc_tpu_torch.ops import resampling as tres
from glabc_tpu_torch.ops import stats as tstats

RTOL = 1e-5


def _xw(x_shape, w_shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=x_shape).astype(np.float32),
            rng.uniform(0.1, 1.0, size=w_shape).astype(np.float32))


@pytest.mark.parametrize("x_shape,w_shape,axis", [
    ((300,), (300,), 0), ((300, 3), (300,), 0),        # 1-D weights
    ((4, 300), (4, 300), 1), ((4, 300, 3), (4, 300), 1),
    ((2, 3, 300, 2), (2, 3, 300), 2)])                 # leading batch axes
@pytest.mark.parametrize("unbiased", [True, False])
def test_weighted_std_axis_matches_dim_and_jax(x_shape, w_shape, axis,
                                               unbiased):
    """``axis=`` is ``dim=``; 1-D weights match the JAX function, and each
    batch row of weights with leading axes matches the JAX function on that
    row (JAX itself normalizes 2-D weights over every entry, a soft spot of
    the reference the port does not copy)."""
    x, w = _xw(x_shape, w_shape, seed=len(x_shape) + axis)
    got = tstats.weighted_std(torch.from_numpy(x), torch.from_numpy(w),
                              unbiased, axis=axis)
    by_dim = tstats.weighted_std(torch.from_numpy(x), torch.from_numpy(w),
                                 unbiased, dim=axis)
    assert torch.equal(got, by_dim)
    lead = w_shape[:-1]
    want = np.stack([np.asarray(jstats.weighted_std(
        jnp.asarray(x[i]), jnp.asarray(w[i]), unbiased, axis=0))
        for i in np.ndindex(*lead)]).reshape(got.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_weighted_std_default_axis_is_0():
    x, w = _xw((200, 2), (200,), seed=7)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(tstats.weighted_std(xt, wt),
                       tstats.weighted_std(xt, wt, axis=0))
    assert torch.equal(tstats.weighted_std(xt, wt, True, 0),
                       tstats.weighted_std(xt, wt, dim=0))


def _one_hot_log_w(shape, axis, seed):
    """Log-weights with one finite entry along ``axis`` per row (the rest
    -inf or NaN), so that every Gumbel-max draw picks it."""
    rng = np.random.default_rng(seed)
    lw = np.full(shape, -np.inf, np.float32)
    lw[rng.random(shape) < 0.2] = np.nan
    moved = np.moveaxis(lw, axis, -1)
    pick = rng.integers(0, moved.shape[-1], size=moved.shape[:-1])
    np.put_along_axis(moved, pick[..., None],
                      rng.normal(size=pick.shape)[..., None].astype(
                          np.float32), axis=-1)
    return np.ascontiguousarray(np.moveaxis(moved, -1, axis)), pick


@pytest.mark.parametrize("shape,axis", [((7,), 0), ((6, 9), -1), ((6, 9), 0),
                                        ((3, 4, 5), 1)])
def test_categorical_axis_matches_dim_and_jax(shape, axis):
    lw, pick = _one_hot_log_w(shape, axis, seed=sum(shape))
    lt = torch.from_numpy(lw)
    got = tres.categorical_from_log_weights(
        lt, torch.Generator().manual_seed(0), axis=axis)
    by_dim = tres.categorical_from_log_weights(
        lt, torch.Generator().manual_seed(0), dim=axis)
    assert torch.equal(got, by_dim)
    np.testing.assert_array_equal(got.numpy(), pick)
    want = np.asarray(jres.categorical_from_log_weights(
        jax.random.PRNGKey(0), jnp.asarray(lw), axis=axis))
    np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_axis_draws_like_dim():
    """On ordinary weights the two keywords give the same draws."""
    lw = torch.from_numpy(np.random.default_rng(3).normal(
        size=(50, 8)).astype(np.float32))
    for ax in (0, 1, -1):
        a = tres.categorical_from_log_weights(
            lw, torch.Generator().manual_seed(11), axis=ax)
        b = tres.categorical_from_log_weights(
            lw, torch.Generator().manual_seed(11), dim=ax)
        assert torch.equal(a, b)


@pytest.mark.parametrize("call", [
    lambda x, w, lw: tstats.weighted_std(x, w, dim=0, axis=0),
    lambda x, w, lw: tstats.weighted_std(x, w, True, 0, axis=1),
    lambda x, w, lw: tres.categorical_from_log_weights(lw, None, dim=-1,
                                                       axis=-1),
    lambda x, w, lw: tres.categorical_from_log_weights(lw, None, 0, axis=0),
])
def test_dim_and_axis_together_raise(call):
    x = torch.randn(20, 2)
    w = torch.rand(20) + 0.1
    lw = torch.randn(4, 5)
    with pytest.raises(ValueError, match="not both"):
        call(x, w, lw)
