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
  the weight image (``pack_bf16_weights``: its matrices in wgmma's
  128-byte swizzle, read back by a pure-Python inverse, its size and
  alignment) and the launch geometry (``bf16_grid``, 64-row tiles).
"""

import struct

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
from glabc_tpu_torch.ops.kernels.flow_kernel import (bf16_grid,
                                                     bf16_layer_image,
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


def _read_bf16_image(raw, dim, H):
    """A pure-Python inverse of one layer's image (the layout of
    ``csrc/coupling_flow_bf16.cu``'s header): ``(w0, b0, w1, b1, w2, b2)``
    as lists of floats, and the set of bytes they came from.  A matrix
    sits K-major in rows of 128 bytes (64 bf16 values of k) with the
    128-byte swizzle: value k of row n at ``kc rows 128 + n 128 + ((k % 64
    // 8) ^ (n % 8)) 16 + (k % 8) 2``; ``w2``'s rows are its columns in the
    order t_0, s_0, t_1, s_1, ..."""
    d2 = dim // 2
    d1, ts = dim - d2, 2 * d2
    kc, tsn = -(-H // 64), (8 if d2 <= 4 else 16)
    used = set()

    def bf16(off):
        used.update((off, off + 1))
        bits = struct.unpack_from("<H", raw, off)[0] << 16
        return struct.unpack("<f", struct.pack("<I", bits))[0]

    def f32(off):
        used.update(range(off, off + 4))
        return struct.unpack_from("<f", raw, off)[0]

    def sw(base, rows, n, k):
        return (base + (k // 64) * rows * 128 + n * 128
                + ((k % 64 // 8) ^ (n % 8)) * 16 + (k % 8) * 2)

    o_w2 = kc * H * 128
    o_w0 = o_w2 + kc * tsn * 128
    o_b0 = o_w0 + d1 * H * 4
    o_b1, o_b2 = o_b0 + H * 4, o_b0 + 2 * H * 4
    row = lambda c: 2 * (c % d2) + c // d2       # w2's column c -> its row
    w1 = [[bf16(sw(0, H, n, k)) for n in range(H)] for k in range(H)]
    w2 = [[bf16(sw(o_w2, tsn, row(c), k)) for c in range(ts)]
          for k in range(H)]
    w0 = [[f32(o_w0 + 4 * (j * H + c)) for c in range(H)] for j in range(d1)]
    b0 = [f32(o_b0 + 4 * c) for c in range(H)]
    b1 = [f32(o_b1 + 4 * c) for c in range(H)]
    b2 = [f32(o_b2 + 4 * row(c)) for c in range(ts)]
    return (w0, b0, w1, b1, w2, b2), used


@pytest.mark.parametrize("dim,hidden", [(d, H) for d in (2, 3, 17)
                                        for H in (16, 48, 128)] + [(17, 32)])
def test_bf16_weight_image(dim, hidden):
    """The per-layer byte image the kernel copies to shared memory with one
    bulk copy: a pure-Python inverse gives back w0, w1, w2 rounded to bf16
    and b0, b1, b2 exactly, every other byte is 0, and the image's size and
    offsets are ``bf16_layer_image``'s, a multiple of 1,024 bytes (the
    128-byte swizzle's atom, where each stage and each matrix starts) and
    of 16 (``cp.async.bulk``)."""
    jf = _jax_flow(dim, n_layers=2, hidden=hidden, seed=dim)
    f = _port(jf)
    d2 = dim // 2
    H = hidden
    img = pack_bf16_weights(f)
    lay = bf16_layer_image(dim, H)
    kc, tsn = -(-H // 64), (8 if d2 <= 4 else 16)
    assert lay["w2"] == kc * H * 128
    assert lay["w0"] == lay["w2"] + kc * tsn * 128
    assert lay["bytes"] % 1024 == 0 and lay["w2"] % 1024 == 0
    assert all(lay[k] % 16 == 0 for k in ("w0", "b0", "b1", "b2"))
    assert lay["bytes"] - 1024 < lay["b2"] + 16 * 4 <= lay["bytes"]
    assert img.dtype == torch.uint8 and img.shape == (2, lay["bytes"])
    r = lambda w: w.detach().to(torch.bfloat16).float().tolist()
    for l in range(2):
        raw = img[l].numpy().tobytes()
        (w0, b0, w1, b1, w2, b2), used = _read_bf16_image(raw, dim, H)
        assert w0 == r(f.w0[l]) and w1 == r(f.w1[l]) and w2 == r(f.w2[l])
        assert b0 == f.b0[l].tolist() and b1 == f.b1[l].tolist()
        assert b2 == f.b2[l].tolist()
        assert not any(raw[i] for i in range(len(raw)) if i not in used)


@pytest.mark.parametrize("n", [1, 31, 777, 8192, 4099, 1 << 20, 32768000,
                               133 * 64])
def test_bf16_grid_covers_the_rows_and_fills_the_card(n):
    """``bf16_grid``'s 64-row tiles per block cover every row once; with no
    more tiles than SMs every tile is a block of its own, above that the
    blocks fill the fewest waves the shared memory allows, none of them
    idle (a single wave at least half full), at the bounds of d=2 and d=17
    at H=128."""
    sms = 132
    for max_tiles in (133, 22):
        per = bf16_grid(n, sms, max_tiles)
        assert 1 <= per <= max_tiles
        rows = per * 64
        blocks = -(-n // rows)
        tiles = -(-n // 64)
        assert blocks * rows >= n and (blocks - 1) * rows < n
        if tiles <= sms:
            assert per == 1 and blocks == tiles
        else:
            waves = -(-blocks // sms)
            assert waves == -(-tiles // (max_tiles * sms))
            assert blocks > (waves - 1) * sms + (sms // 2 if waves == 1
                                                  else 0)


def _slot_flow(flow, x_t, inverse):
    """The bf16 kernel's bookkeeping in torch: the rows' coordinates stay in
    their slots, logical coordinate i of a row in slot (off + i) mod d, a
    layer transforms the slots of its d2 coordinates in place and only
    advances off (by d1 for push, d2 for pull), with the plain bf16
    conditioner for the arithmetic."""
    d, L = flow.dim, flow.n_layers
    d2 = d // 2
    d1 = d - d2
    in0, out0 = (d2, 0) if inverse else (0, d1)
    U = x_t.clone()
    acc = torch.zeros(x_t.shape[1])
    off = 0

    def slot(i):
        return off + i - d if off + i >= d else off + i

    with torch.no_grad():
        for step in range(L):
            l = L - 1 - step if inverse else step
            u1 = torch.stack([U[slot(in0 + j)] for j in range(d1)], dim=1)
            ts = flow._conditioner(l, u1, True)
            t, s = ts[:, :d2], ts[:, d2:]
            for j in range(d2):
                p = slot(out0 + j)
                U[p] = ((U[p] - t[:, j]) * torch.exp(-s[:, j]) if inverse
                        else U[p] * torch.exp(s[:, j]) + t[:, j])
            acc = acc + s.sum(dim=1)
            off = slot(d2 if inverse else d1)
        return torch.stack([U[slot(i)] for i in range(d)]), acc


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dim", [2, 3, 8, 17])
def test_bf16_slots_replace_the_roll(dim, inverse):
    """The kernel moves no coordinate between layers: its slot rotation
    gives the plain bf16 flow's rolled result bit for bit, over a flow of
    more layers than coordinates (the offset wraps)."""
    f = _port(_jax_flow(dim, n_layers=2 * dim + 1, hidden=16, seed=dim))
    x = torch.from_numpy(np.random.default_rng(dim).normal(
        size=(dim, 37)).astype(np.float32))
    want = (f.pull_t if inverse else f.push_t)(x, "bfloat16")
    got = _slot_flow(f, x, inverse)
    assert torch.equal(got[0], want[0].detach())
    assert torch.equal(got[1], want[1].detach())


def test_chip_smoke_reads_registers_and_wgmma():
    """``chip_smoke.py``'s readers of the bf16 kernel's build: registers and
    spills per kernel from ``nvcc -Xptxas -v`` output, and the wgmma
    (HGMMA) and mma.sync (HMMA) instructions per kernel from ``cuobjdump
    -sass`` text, told apart."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    log = """ptxas info    : Compiling entry function '_Z1aILb0EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z1aILb0EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 159 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers
"""
    assert cs.ptxas_registers(log) == {"_Z1aILb0EEvv": (159, 0),
                                       "_Z1bv": (255, 8)}
    sass = """	code for sm_90a
		Function : _Z1aILb0EEvv
        /*0100*/                   HGMMA.64x128x16.F32.BF16 R24, R88, gdesc[UR4], RZ, !UPT ;
        /*0110*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
        /*0120*/                   HGMMA.64x8x16.F32.BF16 R88, R24, gdesc[UR4], R88, gsb0 ;
		Function : _Z1bv
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/              @P0  HMMA.16816.F32.BF16 R4, R8, R14, R4 ;
"""
    assert cs.sass_counts(None, "HGMMA", text=sass) == {"_Z1aILb0EEvv": 2,
                                                        "_Z1bv": 0}
    assert cs.sass_counts(None, "HMMA", text=sass) == {"_Z1aILb0EEvv": 0,
                                                       "_Z1bv": 2}
