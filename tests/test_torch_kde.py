"""The port's weighted KDE and its selection helpers held against glabc_tpu.

Inputs are made from numpy seeds and handed to both packages (the KDE
through ``utils.convert``).

* ``KernelDensity.fit``: support, weights and bandwidth to rtol 1e-6
  (float32 sums in another order), unbatched and batched over chains
  against the vmapped JAX fit.
* ``log_prob`` with and without ``support_chunk``: rtol 1e-5, atol 1e-5.
* ``pick`` (the inverse-CDF component choice of ``sample``) for fixed
  uniforms, and the four resampling helpers: bitwise, with all-valid and
  all-invalid masks and ties in the CDF.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glabc_tpu.models.kde import KernelDensity as JKDE
from glabc_tpu.ops import resampling as jres
from glabc_tpu.ops.stats import weighted_std as j_weighted_std
from glabc_tpu_torch.models.kde import KernelDensity
from glabc_tpu_torch.ops import resampling as res
from glabc_tpu_torch.ops.stats import weighted_std
from glabc_tpu_torch.utils.convert import kde_from_numpy

torch.set_num_threads(1)

FIT_TOL = dict(rtol=1e-6, atol=1e-7)
LP_TOL = dict(rtol=1e-5, atol=1e-5)


def _weights(rng, n, kind):
    if kind is None:
        return None
    w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    if kind == "masked":
        w[rng.uniform(size=n) < 0.3] = 0.0
        w[1] = np.nan
        w[2] = -1.0
    return w


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("kind", [None, "weighted", "masked"])
def test_fit_matches_jax(d, kind):
    rng = np.random.default_rng(10 * d + len(str(kind)))
    X = rng.normal(0.5, 1.3, (97, d)).astype(np.float32)
    w = _weights(rng, 97, kind)
    ref = JKDE.fit(jnp.asarray(X), None if w is None else jnp.asarray(w))
    got = KernelDensity.fit(torch.from_numpy(X),
                            None if w is None else torch.from_numpy(w))
    for f in ("X", "weights", "bandwidth"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), err_msg=f,
                                   **FIT_TOL)
    assert got.bandwidth.shape == (d,)


def test_batched_fit_matches_vmapped_jax():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(16, 60, 2)).astype(np.float32)
    w = np.stack([_weights(rng, 60, "masked") for _ in range(16)])
    w[0] = 1.0                     # one chain with uniform weights
    ref = jax.vmap(JKDE.fit)(jnp.asarray(X), jnp.asarray(w))
    got = KernelDensity.fit(torch.from_numpy(X), torch.from_numpy(w))
    for f in ("X", "weights", "bandwidth"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), err_msg=f,
                                   **FIT_TOL)
    # the batched weighted std is the JAX one, chain by chain
    for c in (0, 7):
        np.testing.assert_allclose(
            weighted_std(X[c], np.nan_to_num(np.clip(w[c], 0, None)),
                         dim=0).numpy(),
            np.asarray(j_weighted_std(jnp.asarray(X[c]), jnp.asarray(
                np.nan_to_num(np.clip(w[c], 0, None))))), **FIT_TOL)


def test_fit_explicit_bandwidth():
    X = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    for bw in (0.3, [0.1, 0.2, 0.3]):
        ref = JKDE.fit(jnp.asarray(X), bandwidth=bw)
        got = KernelDensity.fit(torch.from_numpy(X), bandwidth=bw)
        np.testing.assert_allclose(got.bandwidth.numpy(),
                                   np.asarray(ref.bandwidth), **FIT_TOL)
    with pytest.raises(ValueError):
        KernelDensity.fit(torch.from_numpy(X), bandwidth="nope")


@pytest.mark.parametrize("support_chunk", [0, 7, 64, 200])
@pytest.mark.parametrize("d", [2, 3])
def test_log_prob_matches_jax(support_chunk, d):
    rng = np.random.default_rng(support_chunk + d)
    X = rng.normal(size=(150, d)).astype(np.float32)
    w = _weights(rng, 150, "masked")
    jk = JKDE.fit(jnp.asarray(X), jnp.asarray(w))
    kde = kde_from_numpy(jk.X, jk.weights, jk.bandwidth)
    pts = rng.normal(0, 2.0, (41, d)).astype(np.float32)
    pts[0] = X[3]                   # a point on a support row
    want = np.asarray(jk.log_prob(jnp.asarray(pts),
                                  support_chunk=support_chunk))
    got = kde.log_prob(torch.from_numpy(pts), support_chunk=support_chunk)
    np.testing.assert_allclose(got.numpy(), want, **LP_TOL)
    # one point, unbatched
    np.testing.assert_allclose(
        float(kde.log_prob(torch.from_numpy(pts[5]))),
        float(jk.log_prob(jnp.asarray(pts[5]))), **LP_TOL)


def test_batched_log_prob_matches_vmapped_jax():
    rng = np.random.default_rng(8)
    X = rng.normal(size=(12, 50, 2)).astype(np.float32)
    w = rng.uniform(size=(12, 50)).astype(np.float32)
    jk = jax.vmap(JKDE.fit)(jnp.asarray(X), jnp.asarray(w))
    kde = kde_from_numpy(jk.X, jk.weights, jk.bandwidth)
    pts = rng.normal(size=(12, 30, 2)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda k, x: k.log_prob(x))(
        jk, jnp.asarray(pts)))
    for chunk in (0, 16):
        got = kde.log_prob(torch.from_numpy(pts), support_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want, **LP_TOL)


@pytest.mark.parametrize("kind", ["weighted", "masked", "uniform"])
def test_pick_matches_jax_bitwise(kind):
    """For fixed uniforms the component rows are the JAX package's, by its
    flat and its blocked search alike; zero weights make ties in the CDF,
    and some uniforms land exactly on CDF values.  The CDF itself is a
    float32 cumulative sum, which XLA and torch may round differently in
    the last place (checked to 1e-6); the search runs on the port's CDF."""
    rng = np.random.default_rng(len(kind))
    X = rng.normal(size=(70, 2)).astype(np.float32)
    w = None if kind == "uniform" else _weights(rng, 70, kind)
    jk = JKDE.fit(jnp.asarray(X), None if w is None else jnp.asarray(w))
    kde = kde_from_numpy(jk.X, jk.weights, jk.bandwidth)
    cdf_t = torch.cumsum(kde.weights, dim=-1)
    np.testing.assert_allclose(cdf_t.numpy(),
                               np.asarray(jnp.cumsum(jk.weights)),
                               rtol=1e-6)
    cdf = jnp.asarray(cdf_t.numpy())
    u = rng.uniform(size=500).astype(np.float32)
    u[:20] = (cdf_t.numpy()[rng.integers(0, 70, 20)]
              / cdf_t.numpy()[-1]).astype(np.float32)
    u[20], u[21] = 0.0, np.float32(1.0 - 2 ** -24)
    q = jnp.asarray(u) * cdf[-1]
    flat = jk.X[jnp.clip(jnp.searchsorted(cdf, q, side="right"), 0, 69)]
    blocked, _ = jres.blocked_searchsorted_take(cdf, q, jk.X)
    got = kde.pick(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, np.asarray(flat))
    np.testing.assert_array_equal(got, np.asarray(blocked))


def test_sample_shapes_and_moments():
    g = torch.Generator().manual_seed(0)
    X = torch.tensor([[0.0, 0.0], [10.0, 10.0]])
    kde = KernelDensity.fit(X, torch.tensor([0.25, 0.75]), bandwidth=0.1)
    s = kde.sample(g, 20000)
    assert s.shape == (20000, 2)
    assert abs(float((s[:, 0] > 5).float().mean()) - 0.75) < 0.02
    batched = KernelDensity.fit(torch.randn(3, 40, 2, generator=g))
    assert batched.sample(g, 11).shape == (3, 11, 2)
    assert kde.sample(g, 5, batch=(4,)).shape == (4, 5, 2)
    z, lp = kde.forward(g, 6)
    np.testing.assert_allclose(lp.numpy(), kde.log_prob(z).numpy())


# ------------------------------------------------------------- resampling
def _masks(n):
    rng = np.random.default_rng(n)
    return {"random": rng.uniform(size=n) < 0.6,
            "all_valid": np.ones(n, bool), "all_invalid": np.zeros(n, bool),
            "first_only": np.arange(n) == 0}


@pytest.mark.parametrize("mask", ["random", "all_valid", "all_invalid",
                                  "first_only"])
def test_partition_helpers_match_jax_bitwise(mask):
    n, n_take = 200, 50
    ok = _masks(n)[mask]
    x = np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32)
    perm = jres.stable_partition_indices(jnp.asarray(ok))
    np.testing.assert_array_equal(
        res.stable_partition_indices(torch.from_numpy(ok)).numpy(),
        np.asarray(perm))
    want = np.asarray(jres.stable_partition_take(jnp.asarray(x),
                                                 jnp.asarray(ok), n_take))
    want_b = np.asarray(jres.blocked_stable_partition_take(
        jnp.asarray(x), jnp.asarray(ok), n_take))
    np.testing.assert_array_equal(want, want_b)
    xt, okt = torch.from_numpy(x), torch.from_numpy(ok)
    np.testing.assert_array_equal(
        res.stable_partition_take(xt, okt, n_take).numpy(), want)
    np.testing.assert_array_equal(
        res.blocked_stable_partition_take(xt, okt, n_take).numpy(), want)


def test_partition_helpers_batched_over_chains():
    """A leading chain axis gives, chain by chain, the unbatched result."""
    rng = np.random.default_rng(2)
    ok = rng.uniform(size=(5, 64)) < 0.5
    ok[1] = False
    ok[2] = True
    x = rng.normal(size=(5, 64, 2)).astype(np.float32)
    got = res.stable_partition_take(torch.from_numpy(x), torch.from_numpy(ok),
                                    20)
    got_b = res.blocked_stable_partition_take(torch.from_numpy(x),
                                              torch.from_numpy(ok), 20)
    for c in range(5):
        want = np.asarray(jres.stable_partition_take(
            jnp.asarray(x[c]), jnp.asarray(ok[c]), 20))
        np.testing.assert_array_equal(got[c].numpy(), want)
        np.testing.assert_array_equal(got_b[c].numpy(), want)


@pytest.mark.parametrize("block", [32, 7])
def test_blocked_searchsorted_take_matches_jax_with_ties(block):
    rng = np.random.default_rng(block)
    vals = np.sort(rng.integers(0, 30, 101)).astype(np.float32)   # ties
    q = np.concatenate([vals[::5], rng.uniform(-2, 32, 60),
                        [-1.0, 40.0]]).astype(np.float32)
    payload = rng.normal(size=(101, 2)).astype(np.float32)
    want_p, want_i = jres.blocked_searchsorted_take(
        jnp.asarray(vals), jnp.asarray(q), jnp.asarray(payload), block)
    got_p, got_i = res.blocked_searchsorted_take(
        torch.from_numpy(vals), torch.from_numpy(q),
        torch.from_numpy(payload), block)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_partition_counts_in_int64():
    """Past 2^24 rows the int64 counts stay exact: the last valid row of
    a 2^24 + 3 row mask lands right after the first."""
    n = (1 << 24) + 3
    ok = torch.zeros(n, dtype=torch.bool)
    ok[0] = ok[-1] = True
    perm = res.stable_partition_indices(ok)
    assert perm[:3].tolist() == [0, n - 1, 1]
