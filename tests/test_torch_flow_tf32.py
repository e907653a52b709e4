"""What the float32 coupling-flow kernel (K7, ``csrc/coupling_flow.cu``)
computes on the host and how it rounds, held against glabc_tpu's float32
flow and numpy on the CPU.

* ``split_tf32`` against a numpy reference that rounds to 11 significant
  bits through ``frexp``, half away from zero: ``hi`` and ``lo`` are TF32
  values (low 13 bits clear), ties round away from zero, and ``hi + lo``
  is within 2^-21 |x| of ``x``.
* ``pack_tf32_weights`` read back in fragment order: every lane's B
  fragment holds w1's hi and lo at its (k, n), the padded units included,
  and the rest of the image is w0, b0, b1, w2 and b2 with w2's and b2's t
  and s columns interleaved.
* The 3xTF32 split products on a 32 x 128 flow at 4,099 rows, emulated in
  torch (``tf32_products``), against JAX's float32 ``CouplingFlow.push_t``/``pull_t``: within
  1e-5, as close as the port's own float32 flow; one TF32 product alone
  (the hi parts only) differs by 1e-4 or more, so the kernel's 1e-4 limit
  on the card tells the two apart on this flow.  On flows nearer the
  identity (last layers of a third of this scale) TF32 alone stays near
  5e-5, inside that limit.
* ``flow_grid`` with 16-row small tiles: every row covered, the tiles
  spread over the card.
* The weight image is kept on the flow until a weight changes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glabc_tpu.models.flows import CouplingFlow as JFlow
from glabc_tpu.models.flows import _CouplingStack
from glabc_tpu_torch.ops.kernels.flow_kernel import (_image, flow_grid,
                                                     pack_tf32_weights,
                                                     split_tf32,
                                                     tf32_products)
from glabc_tpu_torch.utils.convert import coupling_flow_from_numpy

torch.set_num_threads(1)


def _tf32_reference(x):
    """x rounded to 11 significant bits, half away from zero, in float64."""
    x = np.asarray(x, np.float64)
    m, e = np.frexp(x)                      # x = m 2^e, 0.5 <= |m| < 1
    q = np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return np.sign(m) * np.ldexp(q, e - 11)


def _split_reference(x):
    hi = _tf32_reference(x)
    return hi, _tf32_reference(np.asarray(x, np.float64) - hi)


def _flow(dim, n_layers, hidden, seed, scale):
    """A JAX flow whose biases, last layers and base are random, so that it
    is not the identity, and the port's copy of it."""
    f = JFlow.create(jax.random.PRNGKey(seed), dim, n_layers, hidden)
    rng = np.random.default_rng(seed)
    st = f.stack
    normal = lambda sd, shape: jnp.asarray(rng.normal(0, sd, shape),
                                           jnp.float32)
    stack = _CouplingStack(
        w0=st.w0, b0=normal(0.1, st.b0.shape), w1=st.w1,
        b1=normal(0.1, st.b1.shape),
        w2=normal(scale / np.sqrt(hidden), st.w2.shape),
        b2=normal(0.1, st.b2.shape))
    base = f.base.__class__(loc=normal(0.3, dim), log_scale=normal(0.2, dim))
    jf = JFlow(base=base, stack=stack)
    return jf, coupling_flow_from_numpy(
        *(getattr(stack, n) for n in ("w0", "b0", "w1", "b1", "w2", "b2")),
        base.loc, base.log_scale)


def test_split_tf32_against_numpy():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=4096) * 10.0 ** rng.uniform(-20, 20, 4096))
    bits = rng.integers(0x08000000, 0x77000000, 512).astype(np.uint32)
    ties = (bits & ~np.uint32(0x1fff)) | np.uint32(0x1000)   # halfway, normal
    x = np.concatenate([x.astype(np.float32), ties.view(np.float32),
                        -ties.view(np.float32), [0.0, 1.0, -2.5]])
    x = x.astype(np.float32)
    hi, lo = (p.numpy() for p in split_tf32(torch.from_numpy(x)))
    want_hi, want_lo = _split_reference(x)
    np.testing.assert_array_equal(hi.astype(np.float64), want_hi)
    np.testing.assert_array_equal(lo.astype(np.float64), want_lo)
    for p in (hi, lo):
        assert not (p.view(np.uint32) & 0x1fff).any()
    tie_hi = hi[4096:4096 + 1024]
    assert (np.abs(tie_hi) > np.abs(x[4096:4096 + 1024])).all()  # away
    resid = np.abs(x.astype(np.float64) - hi - lo.astype(np.float64))
    assert (resid <= 2.0 ** -21 * np.abs(x.astype(np.float64))).all()


@pytest.mark.parametrize("hidden", [8, 48, 128])
def test_tf32_weight_image(hidden):
    """The per-layer image in the order and with the pads of
    ``csrc/coupling_flow.cu`` ``layer_image``, at d=3 and d=17: w1's B
    fragments (HP/8 x HP/8 x 32 lanes x {hi, hi, lo, lo} at the k slots
    t, t + 4 = hidden units 8 kt + 2 t, + 1), w0's (ceil(d1 / 8) k-tiles x
    HP/8 x 32 x {hi, hi, lo, lo} at inputs 8 kk + t, + 4), b0, b1 (HP,),
    w2 (HP, ldw2) and b2 (16,) with t and s interleaved."""
    hp = {8: 32, 48: 64, 128: 128}[hidden]
    nt, pad = hp // 8, hp - hidden
    kt, n_t, lane = np.meshgrid(np.arange(nt), np.arange(nt), np.arange(32),
                                indexing="ij")
    g, t = lane >> 2, lane & 3
    for d, L in ((3, 2), (17, 1)):
        d2 = d // 2
        d1, ts, ldw2, nk0 = d - d2, 2 * d2, (2 * d2 + 3) & ~3, -(-(d - d2) // 8)
        _, f = _flow(d, L, hidden, seed=hidden + d, scale=0.5)
        img = pack_tf32_weights(f).numpy()
        sizes = [2 * hp * hp, nk0 * 16 * hp, hp, hp, hp * ldw2, 16]
        assert img.dtype == np.float32 and img.shape == (L, sum(sizes))
        parts = np.split(img, np.cumsum(sizes)[:-1], axis=1)
        w0, b0, w1, b1, w2, b2 = (w.detach().numpy() for w in f.stack())
        hi1, lo1 = _split_reference(np.pad(w1, ((0, 0), (0, pad), (0, pad))))
        hi0, lo0 = _split_reference(
            np.pad(w0, ((0, 0), (0, 8 * nk0 - d1), (0, pad))))
        frag1 = parts[0].reshape(L, nt, nt, 32, 4)
        frag0 = parts[1].reshape(L, nk0, nt, 32, 4)
        k1, n = 8 * kt + 2 * t, 8 * n_t + g
        for l in range(L):
            for i, (w, dk) in enumerate(((hi1, 0), (hi1, 1), (lo1, 0),
                                         (lo1, 1))):
                np.testing.assert_array_equal(frag1[l][..., i],
                                              w[l][k1 + dk, n])
            for kk in range(nk0):
                k0 = 8 * kk + t[0]
                for i, (w, dk) in enumerate(((hi0, 0), (hi0, 4), (lo0, 0),
                                             (lo0, 4))):
                    np.testing.assert_array_equal(frag0[l, kk][..., i],
                                                  w[l][k0 + dk, n[0]])
        # every (k, n) of the padded widths appears once, the pads as zeros
        assert np.count_nonzero(frag1[..., :2]) == np.count_nonzero(hi1)
        assert np.count_nonzero(frag0[..., :2]) == np.count_nonzero(hi0)
        np.testing.assert_array_equal(parts[2],
                                      np.pad(b0, ((0, 0), (0, pad))))
        np.testing.assert_array_equal(parts[3],
                                      np.pad(b1, ((0, 0), (0, pad))))
        got2 = parts[4].reshape(L, hp, ldw2)
        np.testing.assert_array_equal(got2[:, :hidden, 0:ts:2], w2[..., :d2])
        np.testing.assert_array_equal(got2[:, :hidden, 1:ts:2], w2[..., d2:])
        assert not got2[:, hidden:].any() and not got2[..., ts:].any()
        np.testing.assert_array_equal(parts[5][:, 0:ts:2], b2[:, :d2])
        np.testing.assert_array_equal(parts[5][:, 1:ts:2], b2[:, d2:])
        assert not parts[5][:, ts:].any()


def test_split_products_keep_float32():
    jf, f = _flow(2, 32, 128, seed=0, scale=1.0)
    z = np.random.default_rng(0).normal(size=(2, 4099)).astype(np.float32)
    rel = lambda got, want: max(
        float(np.max(np.abs(a.numpy() - np.asarray(b))
                     / np.maximum(1.0, np.abs(np.asarray(b)))))
        for a, b in zip(got, want))
    for inverse in (False, True):
        want = (jf.pull_t if inverse else jf.push_t)(jnp.asarray(z))
        x = torch.from_numpy(z)
        err3 = rel(tf32_products(f, x, inverse, split=True), want)
        err1 = rel(tf32_products(f, x, inverse, split=False), want)
        with torch.no_grad():
            err32 = rel(f.pull_t(x) if inverse else f.push_t(x), want)
        assert err3 <= 1e-5, (inverse, err3)
        assert err3 <= 2 * err32, (inverse, err3, err32)
        assert err1 >= 10 * 1e-5, (inverse, err1)


@pytest.mark.parametrize("n", [1, 300, 8192, 1 << 20, 32768000])
def test_tf32_grid_covers_the_rows_and_fills_the_card(n):
    sms, max_sub = 132, 31
    warps, nsub, tile = flow_grid(n, sms, max_sub, 16)
    assert 1 <= warps <= 8 and 1 <= nsub <= max_sub and tile in (16, 32)
    rows = warps * nsub * tile
    blocks = -(-n // rows)
    tiles = -(-n // tile)
    assert blocks * rows >= n and (blocks - 1) * rows < n
    if -(-n // 16) <= 8 * sms:
        # 16-row tiles, one per warp, one block per SM, on as many SMs as
        # there are tiles or more than half of them
        assert tile == 16 and nsub == 1 and blocks <= sms
        assert blocks == tiles or blocks > sms // 2
    else:
        # 8 warps of 32-row tiles; whole waves cost at most one tile per
        # warp more than an even share of the tiles over every warp
        waves = -(-blocks // sms)
        assert tile == 32 and warps == 8
        assert waves * nsub <= -(-tiles // (8 * sms)) + nsub


def test_weight_image_is_kept_until_a_weight_changes():
    _, f = _flow(3, 2, 16, seed=5, scale=0.5)
    img = _image(f, pack_tf32_weights)
    assert _image(f, pack_tf32_weights) is img
    torch.testing.assert_close(img, pack_tf32_weights(f), rtol=0, atol=0)
    with torch.no_grad():                  # an in-place write, as a step
        f.w1.mul_(2.0)
    new = _image(f, pack_tf32_weights)
    assert new is not img
    torch.testing.assert_close(new, pack_tf32_weights(f), rtol=0, atol=0)
    opt = torch.optim.Adam(f.parameters(), lr=0.1)
    f.forward_kld(torch.ones((4, 3))).backward()
    opt.step()
    assert _image(f, pack_tf32_weights) is not new
    w2 = f.w2                               # another tensor in its place
    f.w2 = torch.nn.Parameter(w2.detach().clone() + 1.0)
    torch.testing.assert_close(_image(f, pack_tf32_weights),
                               pack_tf32_weights(f), rtol=0, atol=0)
