"""The coupling flow of glabc_tpu_torch held against glabc_tpu's, on the CPU.

* Weights carried across (``coupling_flow_from_numpy``), random nonzero
  last layers: ``push_t``, ``pull_t``, ``log_prob`` and ``forward_kld``
  against JAX ``CouplingFlow`` at d in {2, 3, 8}, to 2e-5 (the tolerance of
  the JAX kernel's own test, ``tests/test_flow_kernel.py:40-48``).
* One and three Adam steps against the optax chain the JAX sampler uses
  (``add_decayed_weights -> scale_by_adam -> scale(-lr)``), every leaf to
  1e-6.
* The K7 plain version (``flow_push_fused``/``flow_pull_fused`` on CPU
  tensors) against the Pallas kernel in interpret mode (no PRNG in the
  kernel, so interpret mode is exact up to float32 rounding), N a multiple
  of the Pallas block and a ragged N (the JAX kernel gets it padded).
* The initialisation's distribution (``lecun_normal``) against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glabc_tpu.models.flows import CouplingFlow as JFlow
from glabc_tpu.models.flows import _CouplingStack
from glabc_tpu.ops.pallas.flow_kernel import (flow_pull_fused as j_pull,
                                              flow_push_fused as j_push)
from glabc_tpu.samplers.glmcmc_nf import GLMCMCNFConfig as JCfg
from glabc_tpu.samplers.glmcmc_nf import make_optimizer as j_make_optimizer
from glabc_tpu_torch.models.flows import CouplingFlow, lecun_normal
from glabc_tpu_torch.ops.kernels import (FlowPull, FlowPush, flow_pull_fused,
                                         flow_push_fused)
from glabc_tpu_torch.samplers.glmcmc_nf import (GLMCMCNFConfig, adam_step,
                                                make_optimizer)
from glabc_tpu_torch.utils.convert import coupling_flow_from_numpy

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _jax_flow(dim, n_layers=3, hidden=16, seed=0, scale=0.3):
    """A JAX flow whose last layers and base are random, so that it is not
    the identity."""
    f = JFlow.create(jax.random.PRNGKey(seed), dim, n_layers, hidden)
    rng = np.random.default_rng(seed)
    st = f.stack
    stack = _CouplingStack(
        w0=st.w0, b0=jnp.asarray(rng.normal(0, 0.1, st.b0.shape), jnp.float32),
        w1=st.w1, b1=jnp.asarray(rng.normal(0, 0.1, st.b1.shape), jnp.float32),
        w2=jnp.asarray(rng.normal(0, scale / np.sqrt(hidden), st.w2.shape),
                       jnp.float32),
        b2=jnp.asarray(rng.normal(0, 0.1, st.b2.shape), jnp.float32))
    base = f.base.__class__(
        loc=jnp.asarray(rng.normal(0, 0.3, dim), jnp.float32),
        log_scale=jnp.asarray(rng.normal(0, 0.2, dim), jnp.float32))
    return JFlow(base=base, stack=stack)


def _port(jf):
    st = jf.stack
    return coupling_flow_from_numpy(st.w0, st.b0, st.w1, st.b1, st.w2, st.b2,
                                    jf.base.loc, jf.base.log_scale)


def _leaves(jf):
    return [jf.base.loc, jf.base.log_scale, *(getattr(jf.stack, n) for n in
                                              ("w0", "b0", "w1", "b1", "w2",
                                               "b2"))]


@pytest.mark.parametrize("dim", [2, 3, 8])
def test_flow_matches_jax(dim):
    jf = _jax_flow(dim, seed=dim)
    f = _port(jf)
    rng = np.random.default_rng(10 + dim)
    z = rng.normal(size=(dim, 200)).astype(np.float32)
    x_ref, s_ref = jf.push_t(jnp.asarray(z))
    with torch.no_grad():
        x, s = f.push_t(torch.from_numpy(z))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)
    xs = (rng.normal(size=(dim, 200)) * 1.5).astype(np.float32)
    z_ref, s_ref = jf.pull_t(jnp.asarray(xs))
    with torch.no_grad():
        zz, s = f.pull_t(torch.from_numpy(xs))
    np.testing.assert_allclose(zz.numpy(), np.asarray(z_ref), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)
    pts = xs.T.copy()
    np.testing.assert_allclose(f.log_prob(torch.from_numpy(pts)).numpy(),
                               np.asarray(jf.log_prob(jnp.asarray(pts))),
                               **TOL)
    np.testing.assert_allclose(
        float(f.forward_kld(torch.from_numpy(pts)).detach()),
        float(jf.forward_kld(jnp.asarray(pts))), **TOL)
    # the flow is not the identity, and sampling is a push of base draws
    assert float(np.abs(x.numpy() - z).max()) > 1e-2
    xx, lq = f(64, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(f.log_prob(xx).numpy(), lq.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_steps_match_optax(steps):
    jf = _jax_flow(2, n_layers=2, hidden=16, seed=3)
    f = _port(jf)
    rng = np.random.default_rng(4)
    data = [(rng.normal(size=(128, 2)) * 1.4).astype(np.float32)
            for _ in range(steps)]
    jopt = j_make_optimizer(JCfg())
    jst = jopt.init(jf)
    for x in data:
        g = jax.grad(lambda fl: fl.forward_kld(jnp.asarray(x)))(jf)
        up, jst = jopt.update(g, jst, jf)
        jf = jax.tree_util.tree_map(lambda a, b: a + b, jf, up)
    opt = make_optimizer(f, GLMCMCNFConfig())
    for x in data:
        adam_step(f, opt, torch.from_numpy(x))
    for name, a, b in zip(("loc", "log_scale", "w0", "b0", "w1", "b1", "w2",
                           "b2"), [getattr(f, n) for n in (
                               "loc", "log_scale", "w0", "b0", "w1", "b1",
                               "w2", "b2")], _leaves(jf)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_adam_step_skips_a_non_finite_loss():
    f = _port(_jax_flow(2, seed=5))
    opt = make_optimizer(f, GLMCMCNFConfig())
    before = [p.detach().clone() for p in f.parameters()]
    x = torch.randn(16, 2)
    x[3] = float("nan")
    loss = adam_step(f, opt, x)
    assert not torch.isfinite(loss)
    assert all(torch.equal(a, b) for a, b in zip(before, f.parameters()))
    assert not opt.state
    adam_step(f, opt, torch.randn(16, 2))
    assert len(opt.state) == 8


@pytest.mark.parametrize("dim,n,padded", [(2, 256, 256), (3, 256, 256),
                                          (8, 256, 256), (2, 300, 384)])
def test_k7_plain_matches_pallas_interpret(dim, n, padded):
    jf = _jax_flow(dim, n_layers=3, hidden=16, seed=20 + dim)
    f = _port(jf)
    rng = np.random.default_rng(dim + n)
    z = np.zeros((dim, padded), np.float32)
    z[:, :n] = rng.normal(size=(dim, n))
    for port_fn, jax_fn, cls in ((flow_push_fused, j_push, FlowPush),
                                 (flow_pull_fused, j_pull, FlowPull)):
        before = cls.launches
        out, s = port_fn(f, torch.from_numpy(z[:, :n].copy()))
        assert cls.launches == before    # the plain version counts nothing
        j_out, j_s = jax_fn(jf, jnp.asarray(z), block_rows=128,
                            interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out)[:, :n],
                                   **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(j_s)[:n], **TOL)
    # pull inverts push
    x, s_f = flow_push_fused(f, torch.from_numpy(z[:, :n].copy()))
    back, s_b = flow_pull_fused(f, x)
    np.testing.assert_allclose(back.numpy(), z[:, :n], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s_b.numpy(), s_f.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_flow_kernel_wrapper_checks():
    f = _port(_jax_flow(2, seed=1))
    with pytest.raises(ValueError, match="x_t"):
        flow_push_fused(f, torch.zeros(3, 10))
    with pytest.raises(TypeError):
        flow_push_fused(f, torch.zeros(2, 10, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        flow_pull_fused(f, torch.zeros(10, 2).T)
    with pytest.raises(ValueError, match="no kernel"):
        FlowPush().run(f.to("meta"), torch.zeros(2, 10, device="meta"))
    with pytest.raises(ValueError):
        CouplingFlow.create(1)


def test_create_matches_jax_initialisation():
    f = CouplingFlow.create(2, 32, 128, generator=torch.Generator()
                            .manual_seed(0))
    jf = JFlow.create(jax.random.PRNGKey(0), 2, 32, 128)
    for a, b in ((f.w0, jf.stack.w0), (f.w1, jf.stack.w1)):
        a = a.detach().numpy()
        b = np.asarray(b)
        assert a.shape == b.shape
        assert abs(a.std() / b.std() - 1.0) < 0.05
        assert np.abs(a).max() <= 2.0 * b.std() / 0.8796 * 1.01
    assert torch.count_nonzero(f.w2) == 0 and torch.count_nonzero(f.b2) == 0
    z = torch.randn(2, 50)
    with torch.no_grad():
        x, s = f.push_t(z)
    assert torch.equal(x, z) and torch.count_nonzero(s) == 0
    w = lecun_normal((4, 8, 16), torch.Generator().manual_seed(1))
    assert w.dtype == torch.float32 and w.shape == (4, 8, 16)
