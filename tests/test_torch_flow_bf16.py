"""The bf16-operand coupling flow (K7-bf16) of glabc_tpu_torch held against
glabc_tpu's, on the CPU.

* The plain version (``flow_push_fused``/``flow_pull_fused(...,
  matmul_dtype='bfloat16')`` on CPU tensors) against the Pallas kernel
  ``FusedCouplingFlow(matmul_dtype='bfloat16')`` in interpret mode, N a
  multiple of the Pallas block and a ragged N (the JAX kernel gets it
  padded), to 2e-5: both round the same operands to bf16 and accumulate in
  float32, so they differ only in the order of the sums.
* JAX's own accuracy band (``tests/test_flow_kernel.py:81-90``): on its
  trained 4 x 32 fixture, bf16 lies within 5e-2 of the float32 flow in the
  log-scale sum, and differs from it (``matmul_dtype`` is not a no-op).
* The rounding sites against a numpy reference that rounds with explicit
  round-to-nearest-even bit arithmetic at the three product operands only,
  and the carried coordinates left unrounded.
* The wrapper's choices and what the kernel's wrapper computes on the host:
  the weight image (``pack_bf16_weights``) and the launch geometry
  (``flow_grid`` with 32-row tiles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glabc_tpu.models.flows import CouplingFlow as JFlow
from glabc_tpu.models.flows import _CouplingStack
from glabc_tpu.ops.pallas.flow_kernel import (flow_pull_fused as j_pull,
                                              flow_push_fused as j_push)
from glabc_tpu_torch.ops.kernels import (FlowPull, FlowPush, flow_pull_fused,
                                         flow_push_fused)
from glabc_tpu_torch.ops.kernels.flow_kernel import (flow_grid,
                                                     pack_bf16_weights)
from glabc_tpu_torch.utils.convert import coupling_flow_from_numpy

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(matmul_dtype="bfloat16")


def _jax_flow(dim, n_layers=3, hidden=16, seed=0, scale=0.3):
    """A JAX flow whose biases, last layers and base are random, so that it
    is not the identity."""
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


def _trained_jax_flow(dim=2, n_layers=4, hidden=32, steps=25):
    """``tests/test_flow_kernel.py``'s ``_trained_flow``: 25 Adam steps of
    forward KL on shifted normal data."""
    flow = JFlow.create(jax.random.PRNGKey(0), dim, n_layers, hidden)
    opt = optax.adam(3e-3)
    st = opt.init(flow)
    data = jax.random.normal(jax.random.PRNGKey(1), (256, dim)) * 1.5 + 0.5
    grad = jax.jit(jax.grad(lambda f: f.forward_kld(data)))
    for _ in range(steps):
        up, st = opt.update(grad(flow), st)
        flow = optax.apply_updates(flow, up)
    return flow


def _port(jf):
    st = jf.stack
    return coupling_flow_from_numpy(st.w0, st.b0, st.w1, st.b1, st.w2, st.b2,
                                    jf.base.loc, jf.base.log_scale)


def _counts():
    return [(c.launches, c.bf16_launches) for c in (FlowPush, FlowPull)]


@pytest.mark.parametrize("dim,n,padded,layers,hidden", [
    (2, 256, 256, 3, 16), (3, 256, 256, 3, 16), (8, 256, 256, 3, 16),
    (2, 300, 384, 3, 16), (3, 256, 256, 4, 32)])
def test_bf16_plain_matches_pallas_interpret(dim, n, padded, layers, hidden):
    jf = _jax_flow(dim, n_layers=layers, hidden=hidden, seed=40 + dim)
    f = _port(jf)
    rng = np.random.default_rng(dim + n)
    z = np.zeros((dim, padded), np.float32)
    z[:, :n] = rng.normal(size=(dim, n)) * 1.3
    before = _counts()
    for port_fn, jax_fn in ((flow_push_fused, j_push),
                            (flow_pull_fused, j_pull)):
        out, s = port_fn(f, torch.from_numpy(z[:, :n].copy()), **BF16)
        j_out, j_s = jax_fn(jf, jnp.asarray(z), block_rows=128,
                            interpret=True, **BF16)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out)[:, :n],
                                   **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(j_s)[:n], **TOL)
        # the float32 variant is a different function at these inputs
        f32, s32 = port_fn(f, torch.from_numpy(z[:, :n].copy()))
        assert float((s32 - s).abs().max()) > 1e-4
    assert _counts() == before           # the plain version counts nothing


def test_bf16_slice_at_full_width_matches_pallas_interpret():
    """The NF flow's width, 32 layers x 128, push and pull."""
    jf = _jax_flow(2, n_layers=32, hidden=128, seed=7, scale=0.1)
    f = _port(jf)
    z = np.random.default_rng(7).normal(size=(2, 128)).astype(np.float32)
    for port_fn, jax_fn in ((flow_push_fused, j_push),
                            (flow_pull_fused, j_pull)):
        out, s = port_fn(f, torch.from_numpy(z), **BF16)
        j_out, j_s = jax_fn(jf, jnp.asarray(z), block_rows=128,
                            interpret=True, **BF16)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(j_s), **TOL)


@pytest.mark.parametrize("fn", ["push", "pull"])
def test_bf16_within_jax_band_of_f32(fn):
    jf = _trained_jax_flow()
    f = _port(jf)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2, 256)))
    port_fn = flow_push_fused if fn == "push" else flow_pull_fused
    x32, s32 = port_fn(f, torch.from_numpy(z.copy()))
    x16, s16 = port_fn(f, torch.from_numpy(z.copy()), **BF16)
    assert torch.isfinite(x16).all() and torch.isfinite(s16).all()
    assert float((s16 - s32).abs().max()) < 5e-2
    assert float((s16 - s32).abs().max()) > 1e-5
    if fn == "push":    # the JAX test's own reference: the XLA float32 flow
        _, s_ref = jf.push_t(jnp.asarray(z))
        assert float(np.abs(s16.numpy() - np.asarray(s_ref)).max()) < 5e-2


def _rne_bf16(x):
    """float32 -> the nearest bfloat16 value (ties to even), as float32, by
    bit arithmetic on the float32 pattern."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def _numpy_flow(f, x, inverse, rounded=("u1", "h0", "h1")):
    """The bf16-operand flow in numpy: float64 products and sums of the
    rounded operands, rounded to float32 after each bias; ``rounded`` names
    the activations whose rounding is kept (the weights always are)."""
    w0, b0, w1, b1, w2, b2 = (w.detach().numpy() for w in f.stack())
    r = lambda name, t: _rne_bf16(t) if name in rounded else t
    d = x.shape[0]
    d2 = d // 2
    d1 = d - d2
    u = x.T.astype(np.float32)
    acc = np.zeros(u.shape[0], np.float32)
    layers = range(f.n_layers)
    for l in (reversed(layers) if inverse else layers):
        u1 = u[:, d2:] if inverse else u[:, :d1]
        dot = lambda a, w: (a.astype(np.float64)
                            @ _rne_bf16(w).astype(np.float64))
        h = np.maximum((dot(r("u1", u1), w0[l]) + b0[l]).astype(np.float32),
                       0)
        h = np.maximum((dot(r("h0", h), w1[l]) + b1[l]).astype(np.float32),
                       0)
        ts = (dot(r("h1", h), w2[l]) + b2[l]).astype(np.float32)
        t, s = ts[:, :d2], ts[:, d2:]
        if inverse:
            u = np.concatenate([u1, (u[:, :d2] - t) * np.exp(-s)], axis=1)
        else:
            u = np.concatenate([u[:, d1:] * np.exp(s) + t, u1], axis=1)
        acc = acc + s.sum(axis=1, dtype=np.float32)
    return u.T, acc


@pytest.mark.parametrize("dim", [2, 5])
def test_bf16_rounds_the_product_operands_only(dim):
    jf = _jax_flow(dim, n_layers=2, hidden=16, seed=60 + dim, scale=1.0)
    f = _port(jf)
    with torch.no_grad():   # w1 off the bf16 grid: low mantissa bits set
        f.w1.mul_(1.0 + 2.0 ** -12)
    assert not np.array_equal(_rne_bf16(f.w1.detach().numpy()),
                              f.w1.detach().numpy())
    z = (np.random.default_rng(dim).normal(size=(dim, 64)) * 1.7).astype(
        np.float32)
    for inverse, port_fn in ((False, flow_push_fused),
                             (True, flow_pull_fused)):
        out, s = port_fn(f, torch.from_numpy(z), **BF16)
        ref, s_ref = _numpy_flow(f, z, inverse)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-5, atol=1e-5)
        # leaving any one activation unrounded is another function
        for keep in (("h0", "h1"), ("u1", "h1"), ("u1", "h0")):
            _, s_other = _numpy_flow(f, z, inverse, rounded=keep)
            assert np.abs(s_other - s_ref).max() > 1e-4, keep


def test_bf16_carries_the_untransformed_coordinates_unrounded():
    jf = _jax_flow(3, n_layers=1, hidden=16, seed=3)
    f = _port(jf)
    z = (np.random.default_rng(3).normal(size=(3, 50)) * (1 + 2.0 ** -20)
         ).astype(np.float32)
    assert not np.array_equal(_rne_bf16(z), z)
    x, _ = flow_push_fused(f, torch.from_numpy(z), **BF16)
    # push with one layer: [u1; u2] -> [v2; u1], u1 = the first d1 = 2 rows
    assert np.array_equal(x.numpy()[1:], z[:2])
    back, _ = flow_pull_fused(f, torch.from_numpy(z), **BF16)
    # pull: [v2; u1] -> [u1; ...], u1 = the last d1 rows
    assert np.array_equal(back.numpy()[:2], z[1:])


def test_bf16_wrapper_checks():
    f = _port(_jax_flow(2, seed=1))
    z = torch.randn(2, 40, generator=torch.Generator().manual_seed(0))
    for bad in ("float16", "bf16", None):
        with pytest.raises(ValueError, match="matmul_dtype"):
            flow_push_fused(f, z, matmul_dtype=bad)
        with pytest.raises(ValueError, match="matmul_dtype"):
            FlowPull(bad)
        with pytest.raises(ValueError, match="matmul_dtype"):
            f.pull_t(z, bad)
    before = _counts()
    # the default is the float32 flow, unchanged
    x, s = flow_push_fused(f, z)
    with torch.no_grad():
        x_ref, s_ref = f.push_t(z)
    assert torch.equal(x, x_ref) and torch.equal(s, s_ref)
    x16, _ = FlowPush("bfloat16").run(f, z)
    assert not torch.equal(x16, x)
    assert _counts() == before
    assert FlowPush.bf16_launches == FlowPull.bf16_launches == 0


@pytest.mark.parametrize("dim,hidden", [(2, 128), (3, 16), (17, 32)])
def test_bf16_weight_image(dim, hidden):
    """The per-layer byte image the kernel copies to shared memory, in the
    order and with the pads of ``csrc/coupling_flow_bf16.cu`` ``layer_image``:
    w1 (H, H + 8) and w2 (H, 24) bf16, w0 (d1, H), b0, b1 (H,), b2 (16,)
    float32."""
    jf = _jax_flow(dim, n_layers=2, hidden=hidden, seed=dim)
    f = _port(jf)
    d2 = dim // 2
    d1, ts, H = dim - d2, 2 * d2, hidden
    img = pack_bf16_weights(f)
    sizes = [H * (H + 8) * 2, H * 24 * 2, d1 * H * 4, H * 4, H * 4, 16 * 4]
    assert img.dtype == torch.uint8 and img.shape == (2, sum(sizes))
    assert all(s % 16 == 0 for s in sizes)     # 16-byte cp.async chunks
    parts = torch.split(img, sizes, dim=1)
    bf = lambda p, shape: p.contiguous().view(torch.bfloat16).reshape(
        2, *shape).float()
    fl = lambda p, shape: p.contiguous().view(torch.float32).reshape(
        2, *shape)
    r = lambda w: w.detach().to(torch.bfloat16).float()
    w1, w2 = bf(parts[0], (H, H + 8)), bf(parts[1], (H, 24))
    assert torch.equal(w1[..., :H], r(f.w1))
    assert torch.count_nonzero(w1[..., H:]) == 0
    assert torch.equal(w2[..., :ts], r(f.w2))
    assert torch.count_nonzero(w2[..., ts:]) == 0
    assert torch.equal(fl(parts[2], (d1, H)), r(f.w0))
    assert torch.equal(fl(parts[3], (H,)), f.b0.detach())
    assert torch.equal(fl(parts[4], (H,)), f.b1.detach())
    b2 = fl(parts[5], (16,))
    assert torch.equal(b2[:, :ts], f.b2.detach())
    assert torch.count_nonzero(b2[:, ts:]) == 0


@pytest.mark.parametrize("n", [1, 31, 777, 8192, 4099, 1 << 20, 32768000])
def test_bf16_grid_covers_the_rows_and_fills_the_card(n):
    sms, max_sub = 132, 35
    warps, nsub, tile = flow_grid(n, sms, max_sub, 32)
    assert 1 <= warps <= 8 and 1 <= nsub <= max_sub and tile == 32
    rows = warps * nsub * 32
    blocks = -(-n // rows)
    tiles = -(-n // 32)
    assert blocks * rows >= n and (blocks - 1) * rows < n
    if tiles >= 8 * sms:         # whole waves of 8-warp blocks
        assert warps == 8
        waves = -(-blocks // sms)
        assert blocks > (waves - 1) * sms + sms // 2
    else:                        # one tile per warp, spread over the SMs
        assert nsub == 1 and blocks <= sms
        assert blocks == tiles or blocks > sms // 2
