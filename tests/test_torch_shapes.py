"""The shapes past the static kernels' (flows at any hidden width and at dims
above 17, K3, K4 and K5 above theta_dim 32), held against glabc_tpu on the
CPU.

* The plain float32 and bf16 flows against JAX ``CouplingFlow`` push and
  pull (the bf16 one against ``flow_push_fused``/``flow_pull_fused(
  matmul_dtype='bfloat16')``'s arithmetic: JAX's ``_layer`` on bf16
  operands, composed here), weights carried over by
  ``coupling_flow_from_numpy``, at (dim, hidden) in {(20, 100), (33, 136),
  (2, 256)}, 2 layers: float32 to 2e-5 (the JAX kernel's own test's
  tolerance); bf16 to 2e-5 on all but 1 % of the values and 1e-3 on
  every one (relative to max(1, |x|)): torch and XLA add a product's
  terms in other orders, and where the float32 sums differ in their last
  bit a bf16 rounding of h0 or h1 can step by one bf16 ulp.
* The weight images: a flow of hidden width 100 packs to the image of the
  same flow zero-padded to the kernel's width, slot for slot (the
  weight-resident float32 and bf16 images and the wide one); the wide
  image read back in the CUDA kernel's order gives the weights again
  (float32: hi + lo within 2^-21 relative; bf16: the bf16 rounding).
* The plain K3, K4 and K5 at d in {33, 40} against JAX functions that run
  through XLA (not the Pallas kernels, whose interpret mode has no random
  bits): K3 against an iSIR step composed from ``jnp.argmax`` and
  ``sanitize_log_weights`` on the same Gumbels, exactly; K4 against the
  vmapped ``KernelDensity.log_prob`` to 2e-4 max(1, |log q|) (another
  formula); K5's transition against the step composed from
  ``HighDimMixtureProblem``'s functions on the same noise, to 1e-5.
* The wrappers' shape checks take every new shape (K7: hidden 1..512 and
  dim 2..64; K3/K4/K5: d up to 128) and raise past them, before anything
  is built or launched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glabc_tpu.models.flows import CouplingFlow as JFlow
from glabc_tpu.models.flows import _CouplingStack
from glabc_tpu.models.kde import KernelDensity as JKDE
from glabc_tpu.models.problems import HighDimMixtureProblem as JHighDim
from glabc_tpu.ops.resampling import sanitize_log_weights
from glabc_tpu_torch.models.flows import CouplingFlow
from glabc_tpu_torch.ops.kernels import (BatchedMixtureLogProb, FlowPull,
                                         FlowPush, PoolISIR, PoolISIRMixed,
                                         _build, batched_kde_log_prob,
                                         resident_from_kde)
from glabc_tpu_torch.ops.kernels import flow_kernel as fk
from glabc_tpu_torch.ops.kernels.pool_isir_mixed_kernel import (
    MixedNoise, mixed_transition)
from glabc_tpu_torch.utils.convert import (coupling_flow_from_numpy,
                                           kde_from_numpy)

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
FLOW_SHAPES = [(20, 100), (33, 136), (2, 256)]


def _jax_flow(dim, hidden, n_layers=2, seed=0):
    """A JAX flow whose last layers, biases and base are random, so that
    it is not the identity."""
    f = JFlow.create(jax.random.PRNGKey(seed), dim, n_layers, hidden)
    rng = np.random.default_rng(seed)
    st = f.stack
    r = lambda scale, shape: jnp.asarray(rng.normal(0, scale, shape),
                                         jnp.float32)
    stack = _CouplingStack(w0=st.w0, b0=r(0.1, st.b0.shape), w1=st.w1,
                           b1=r(0.1, st.b1.shape),
                           w2=r(0.3 / np.sqrt(hidden), st.w2.shape),
                           b2=r(0.1, st.b2.shape))
    base = f.base.__class__(loc=r(0.3, dim), log_scale=r(0.2, dim))
    return JFlow(base=base, stack=stack)


def _port(jf):
    st = jf.stack
    return coupling_flow_from_numpy(st.w0, st.b0, st.w1, st.b1, st.w2, st.b2,
                                    jf.base.loc, jf.base.log_scale)


def _bf16(a):
    return a.astype(jnp.bfloat16).astype(jnp.float32)


def _jax_bf16_flow(jf, x, inverse):
    """JAX's bf16 flow (``FusedCouplingFlow._layer`` with
    ``matmul_dtype='bfloat16'``: the three products on bf16 operands,
    float32 accumulation) composed from jnp, on ``x (dim, N)``."""
    st = jf.stack
    d = x.shape[0]
    d2 = d // 2
    d1 = d - d2
    u, acc = x.T, jnp.zeros(x.shape[1], jnp.float32)
    dot = lambda a, b: jnp.dot(_bf16(a), _bf16(b),
                               precision=jax.lax.Precision.HIGHEST)
    layers = range(st.w0.shape[0])
    for l in (reversed(layers) if inverse else layers):
        u1 = u[:, d2:] if inverse else u[:, :d1]
        h = jax.nn.relu(dot(u1, st.w0[l]) + st.b0[l])
        h = jax.nn.relu(dot(h, st.w1[l]) + st.b1[l])
        ts = dot(h, st.w2[l]) + st.b2[l]
        t, s = ts[:, :d2], ts[:, d2:]
        if inverse:
            u = jnp.concatenate([u1, (u[:, :d2] - t) * jnp.exp(-s)], axis=1)
        else:
            u = jnp.concatenate([u[:, d1:] * jnp.exp(s) + t, u1], axis=1)
        acc = acc + s.sum(axis=1)
    return np.asarray(u.T), np.asarray(acc)


# -------------------------------------------------------- K7: plain flows
@pytest.mark.parametrize("dim,hidden", FLOW_SHAPES)
def test_plain_flow_matches_jax_at_new_shapes(dim, hidden):
    jf = _jax_flow(dim, hidden, seed=dim + hidden)
    f = _port(jf)
    rng = np.random.default_rng(dim * hidden)
    z = rng.normal(size=(dim, 300)).astype(np.float32)
    x_ref, s_ref = jf.push_t(jnp.asarray(z))
    x, s = FlowPush().run(f, torch.from_numpy(z))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)
    z_ref, sp_ref = jf.pull_t(jnp.asarray(x_ref))
    zz, sp = FlowPull().run(f, torch.from_numpy(np.array(x_ref)))
    np.testing.assert_allclose(zz.numpy(), np.asarray(z_ref), **TOL)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sp_ref), **TOL)
    assert FlowPush.wide_launches == 0 and FlowPull.wide_launches == 0


@pytest.mark.parametrize("dim,hidden", FLOW_SHAPES)
def test_plain_bf16_flow_matches_jax_at_new_shapes(dim, hidden):
    jf = _jax_flow(dim, hidden, seed=3 * dim + hidden)
    f = _port(jf)
    rng = np.random.default_rng(dim + 7 * hidden)
    z = rng.normal(size=(dim, 300)).astype(np.float32)
    for cls, inverse in ((FlowPush, False), (FlowPull, True)):
        want = _jax_bf16_flow(jf, jnp.asarray(z), inverse)
        got = cls("bfloat16").run(f, torch.from_numpy(z))
        for a, b in zip(got, want):
            rel = np.abs(a.numpy() - b) / np.maximum(1.0, np.abs(b))
            assert rel.max() <= 1e-3 and (rel > 2e-5).mean() <= 0.01, (
                rel.max(), (rel > 2e-5).mean())
        # and it is a bf16 flow: the float32 one is further away
        f32 = cls().run(f, torch.from_numpy(z))
        assert np.abs(f32[1].numpy() - want[1]).max() > 1e-4


# ------------------------------------------------------ K7: weight images
def _padded(flow, width):
    """``flow`` with its hidden units zero-padded to ``width``."""
    w0, b0, w1, b1, w2, b2 = (w.detach() for w in flow.stack())
    p = width - flow.hidden
    pad = torch.nn.functional.pad
    return CouplingFlow(flow.loc.detach(), flow.log_scale.detach(),
                        pad(w0, (0, p)), pad(b0, (0, p)),
                        pad(w1, (0, p, 0, p)), pad(b1, (0, p)),
                        pad(w2, (0, 0, 0, p)), b2)


@pytest.mark.parametrize("dim", [2, 3, 17])
def test_resident_images_zero_pad_the_hidden_width(dim):
    f = _port(_jax_flow(dim, 100, seed=dim))
    assert fk._tf32_width(100) == 128 and fk._bf16_width(100) == 112
    assert torch.equal(fk.pack_tf32_weights(f),
                       fk.pack_tf32_weights(_padded(f, 128)))
    assert torch.equal(fk.pack_bf16_weights(f),
                       fk.pack_bf16_weights(_padded(f, 112)))
    # a width the parent took packs as it did: no pad, the same layout
    g = _port(_jax_flow(dim, 48, seed=dim))
    assert fk.pack_bf16_weights(g).shape[1] == fk.bf16_layer_image(
        dim, 48)["bytes"]


@pytest.mark.parametrize("dim,hidden,width", [(20, 100, 128), (2, 300, 320),
                                              (33, 136, 192)])
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_image_zero_pads_the_hidden_width(dim, hidden, width, bf16):
    f = _port(_jax_flow(dim, hidden, seed=hidden))
    assert fk.wide_layout(dim, hidden, bf16)["HP"] == width
    got = fk.pack_wide_weights(f, bf16)
    want = fk.pack_wide_weights(_padded(f, width), bf16)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _read_wide(img, d, H, bf16):
    """The weights back from one layer's wide image, read in the CUDA
    kernel's fragment order (``csrc/coupling_flow_wide.cu``): float32 as
    hi + lo, bf16 words as two bf16 halves."""
    o = fk.wide_layout(d, H, bf16)
    hp, nk, sf, tsp = o["HP"], o["nk"], o["sf"], o["tsp"]
    nq = hp // 32
    d2 = d // 2
    d1, ts = d - d2, 2 * d2
    w0 = np.zeros((d1, hp))
    w1 = np.zeros((hp, hp))
    b0 = np.zeros(hp)
    halves = img.view(np.int16)
    as_bf16 = lambda h: (h.astype(np.int32) << 16).view(np.float32)
    for c in range(hp // 64):
        for q in range(nq):
            s0 = (c * nq + q) * sf
            b0[32 * q:32 * q + 32] = img[s0 + sf - 32:s0 + sf]
            if bf16:        # w0 as (d1, 32) floats
                w0[:, 32 * q:32 * q + 32] = img[s0 + o["w0"]:][:32 * d1] \
                    .reshape(d1, 32)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                if not bf16:
                    for j in range(4):
                        for nt in range(8):
                            e = img[s0 + ((j * 8 + nt) * 32 + lane) * 4:][:4]
                            k, n = 32 * q + 8 * j + 2 * t, 64 * c + 8 * nt + g
                            w1[k, n], w1[k + 1, n] = e[0] + e[2], e[1] + e[3]
                        for kk in range(nk):
                            e = img[s0 + o["w0"]
                                    + ((j * nk + kk) * 32 + lane) * 4:][:4]
                            u = 32 * q + 8 * j + g
                            if 8 * kk + t < d1:
                                w0[8 * kk + t, u] = e[0] + e[2]
                            if 8 * kk + t + 4 < d1:
                                w0[8 * kk + t + 4, u] = e[1] + e[3]
                    continue
                for j in range(2):
                    for nt in range(8):
                        h = as_bf16(halves[2 * s0 + ((j * 8 + nt) * 32
                                                     + lane) * 4:][:4])
                        k, n = 32 * q + 16 * j + 2 * t, 64 * c + 8 * nt + g
                        w1[[k, k + 1, k + 8, k + 9], n] = h
    b1 = img[o["b1"]:o["b1"] + hp]
    w2 = img[o["w2"]:o["w2"] + hp * tsp].reshape(hp, tsp)
    b2 = img[o["b2"]:o["b2"] + tsp]
    col = [(c % 2) * d2 + c // 2 for c in range(ts)]
    inv = np.argsort(col)
    return (w0[:, :H], b0[:H], w1[:H, :H], b1[:H], w2[:H, :ts][:, inv],
            b2[:ts][inv], w2[H:], w2[:, ts:])


@pytest.mark.parametrize("dim,hidden", [(20, 100), (33, 136), (64, 64),
                                        (2, 8)])
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_image_reads_back_in_fragment_order(dim, hidden, bf16):
    f = _port(_jax_flow(dim, hidden, seed=dim * hidden))
    img = fk.pack_wide_weights(f, bf16)
    assert img.shape == (2, fk.wide_layout(dim, hidden, bf16)["floats"])
    want = [w.detach().numpy() for w in f.stack()]
    for l in range(2):
        *got, pad_rows, pad_cols = _read_wide(img[l].numpy(), dim, hidden,
                                              bf16)
        assert not pad_rows.any() and not pad_cols.any()
        for i, (a, b) in enumerate(zip(got, want)):
            b = b[l]
            if bf16 and i in (0, 2, 4):     # w0, w1, w2 rounded to bf16
                b = np.asarray(_bf16(jnp.asarray(b)))
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=2 ** -21, atol=0)


def test_wide_layout_fits_the_shared_memory():
    """The wide kernel's ring, coordinates and ts of 8 warps of 32 rows at
    dim 64 (``wide_smem`` in the CUDA source) fit the 227 KB of a block."""
    for bf16 in (False, True):
        o = fk.wide_layout(64, 512, bf16)
        rb = 8 * 32
        assert (2 * o["sf"] + (64 + 1 + o["tsp"]) * rb) * 4 <= 232448
        assert o["sf"] % 4 == 0 and o["floats"] % 4 == 0


# ------------------------------------------------------- K7: shape checks
def test_flow_variants_and_limits():
    assert fk.kernel_variant(2, 128) == "resident"
    assert fk.kernel_variant(17, 1) == "resident"
    assert fk.kernel_variant(17, 100) == "resident"
    for d, h in ((18, 8), (2, 129), (64, 512), (33, 256)):
        assert fk.kernel_variant(d, h) == "wide"
    for d, h in ((65, 8), (1, 8), (2, 513), (2, 0)):
        with pytest.raises(ValueError, match="dim <= 64 and 1 <= hidden "
                                             "<= 512"):
            fk.kernel_variant(d, h)


@pytest.mark.parametrize("dim,hidden", [(2, 1), (2, 100), (2, 12), (17, 136),
                                        (20, 8), (64, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flow_launch_takes_the_new_shapes(dim, hidden, dtype):
    """Every new shape passes the checks and reaches the launch (a meta
    tensor stands in for a CUDA one and is refused there)."""
    f = CouplingFlow.create(dim, 2, hidden).to("meta")
    for cls in (FlowPush, FlowPull):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            cls(dtype).run(f, torch.zeros(dim, 10, device="meta"))


@pytest.mark.parametrize("dim,hidden", [(2, 513), (66, 8)])
def test_flow_launch_refuses_past_the_limits(dim, hidden):
    f = CouplingFlow.create(dim, 2, hidden).to("meta")
    for dtype in ("float32", "bfloat16"):
        with pytest.raises(ValueError, match="hidden <= 512"):
            FlowPush(dtype).run(f, torch.zeros(dim, 10, device="meta"))


# ---------------------------------------------------------- K3, K4, K5
class _Reached(Exception):
    pass


@pytest.fixture
def no_build(monkeypatch):
    """``load_library`` raising ``_Reached``: a launch that gets past its
    shape checks stops there, with nothing built."""
    def stop(*a, **k):
        raise _Reached
    monkeypatch.setattr(_build, "load_library", stop)


def _meta(*shapes):
    return [torch.zeros(s, device="meta") for s in shapes]


@pytest.mark.parametrize("d", [33, 64, 128, 129])
def test_agl_kernels_take_d_up_to_128(no_build, d):
    want = pytest.raises(_Reached) if d <= 128 else pytest.raises(
        ValueError, match="<= 128")
    T, B, C = 4, 5, 32
    with want:
        PoolISIR(d, batch_size=B, steps_per_call=T)._launch(
            0, *_meta((T, B, d, C), (T, B, C), (d, C), (C,)), 0, 0)
    with want:
        BatchedMixtureLogProb()._launch(*_meta((2, 3, d), (2, 4, d), (2, 4),
                                               (2, d)))
    kern = PoolISIRMixed(d, np.ones(d, np.float32), steps_per_call=T,
                         batch_size=B)
    res = resident_from_kde(kde_from_numpy(np.zeros((4, d), np.float32),
                                           np.ones(4, np.float32),
                                           np.ones(d, np.float32)))
    with want:
        kern._launch(0, res, *_meta((T, B, d, C), (T, B, d, C), (T, B, C),
                                    (T, B, C), (d, C), (d, C), (C,)), 0, 0)


def _isir_jax(pool_theta, pool_logw, theta, logw, g):
    """K3's T steps composed from jnp: argmax (the first maximum) over the
    current state and the B candidates, on Gumbels ``g (T, C, B + 1)``
    (the current state's last, as the kernel draws them)."""
    T, B = pool_logw.shape[:2]
    th, lw = jnp.asarray(theta), jnp.asarray(logw)
    sel = jnp.full(lw.shape, -1.0)
    moved = jnp.zeros(lw.shape)
    hist = []
    for t in range(T):
        cand = jnp.concatenate([lw[None], jnp.asarray(pool_logw[t])], 0)
        gum = jnp.concatenate([g[t][:, B:].T, g[t][:, :B].T], 0)
        idx = jnp.argmax(sanitize_log_weights(cand) + gum, axis=0)
        mv = idx > 0
        pick = jnp.maximum(idx - 1, 0)
        cols = jnp.arange(lw.shape[0])
        th = jnp.where(mv[None], jnp.asarray(pool_theta[t])[pick, :, cols].T,
                       th)
        lw = jnp.where(mv, jnp.asarray(pool_logw[t])[pick, cols], lw)
        sel = jnp.where(mv, (t * B + pick).astype(jnp.float32), sel)
        moved = moved + mv
        hist.append(th)
    return [np.asarray(a) for a in (th, lw, sel, moved, jnp.stack(hist))]


@pytest.mark.parametrize("d", [33, 40])
def test_pool_isir_plain_matches_jax_at_wide_d(d):
    T, B, C = 6, 5, 96
    rng = np.random.default_rng(d)
    pt = rng.normal(size=(T, B, d, C)).astype(np.float32)
    pw = rng.normal(-3.0, 2.0, (T, B, C)).astype(np.float32)
    pw[rng.uniform(size=pw.shape) < 0.2] = -np.inf
    th = rng.normal(size=(d, C)).astype(np.float32)
    lw = rng.normal(-3.0, 2.0, C).astype(np.float32)
    lw[:5] = -np.inf
    g = (-np.log(-np.log(rng.uniform(size=(T, C, B + 1))))).astype(
        np.float32)
    t = torch.from_numpy
    got = PoolISIR(d, batch_size=B, steps_per_call=T).plain(
        0, t(pt), t(pw), t(th), t(lw), gumbels=lambda s: t(g[s]))
    want = _isir_jax(pt, pw, th, lw, g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    assert 0 < float(got[3].mean()) < T


@pytest.mark.parametrize("d", [33, 40])
def test_kde_logprob_plain_matches_jax_at_wide_d(d):
    C, P, N = 16, 40, 24
    rng = np.random.default_rng(d)
    X = rng.normal(size=(C, P, d)).astype(np.float32)
    w = rng.uniform(size=(C, P)).astype(np.float32)
    w[:, ::5] = 0.0
    jk = jax.vmap(JKDE.fit)(jnp.asarray(X), jnp.asarray(w))
    x = (X[:, :N] + rng.normal(0, 0.3, (C, N, d))).astype(np.float32)
    want = np.asarray(jax.vmap(lambda k, p: k.log_prob(p))(jk, jnp.asarray(x)))
    got = batched_kde_log_prob(kde_from_numpy(jk.X, jk.weights, jk.bandwidth),
                               torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    assert np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))) <= 2e-4
    assert BatchedMixtureLogProb.wide_launches == 0


@pytest.mark.parametrize("d", [33, 40])
def test_mixed_transition_matches_jax_at_wide_d(d):
    B, N, gf = 5, 256, 0.5
    prob = JHighDim(d)
    rng = np.random.default_rng(d)
    f32 = lambda a: np.asarray(a, np.float32)
    jkde = JKDE.fit(jnp.asarray(rng.normal(1.0, 1.0, (64, d)), jnp.float32))
    theta = f32(rng.normal(1.0, 0.3, (N, d)))
    y = f32(np.abs(theta) + 0.2 * rng.normal(size=(N, d)))
    logk = f32(prob.kernel_log_prob(prob.discrepancy(jnp.asarray(y))))
    sl = (f32(rng.normal(1.0, 0.3, (N, B, d))),
          f32(rng.normal(1.5, 0.3, (N, B, d))),
          f32(rng.normal(-6.0, 3.0, (N, B))), f32(rng.normal(-2, 1, (N, B))))
    nz = dict(g=f32(-np.log(-np.log(rng.uniform(size=(N, B + 1))))),
              u_local=f32(rng.uniform(size=N)),
              u_coin=f32(rng.uniform(size=N)),
              l1=f32(rng.normal(size=(N, d))), l2=f32(rng.normal(size=(N, d))))
    # the step composed from glabc_tpu's functions (XLA)
    th_j, y_j, lk_j = (jnp.asarray(a) for a in (theta, y, logk))
    lp_theta = prob.prior_log_prob(th_j)
    log_w = jnp.concatenate([(lp_theta + lk_j - jkde.log_prob(th_j))[:, None],
                             jnp.asarray(sl[2])], axis=1)
    idx = jnp.argmax(sanitize_log_weights(log_w) + nz["g"], axis=1)
    moved = idx > 0
    pick = jnp.maximum(idx - 1, 0)
    rows = jnp.arange(N)
    thl = th_j + 0.35 * nz["l1"]
    yl = jnp.abs(thl) + prob._noise_std * nz["l2"]
    lkl = prob.kernel_log_prob(prob.discrepancy(yl))
    l_acc = jnp.log(nz["u_local"]) < (prob.prior_log_prob(thl) + lkl
                                      - lp_theta - lk_j)
    is_g = nz["u_coin"] < gf
    want = (jnp.where(is_g[:, None], jnp.where(moved[:, None],
                                               sl[0][rows, pick], th_j),
                      jnp.where(l_acc[:, None], thl, th_j)),
            jnp.where(is_g[:, None], jnp.where(moved[:, None],
                                               sl[1][rows, pick], y_j),
                      jnp.where(l_acc[:, None], yl, y_j)),
            jnp.where(is_g, jnp.where(moved, sl[3][rows, pick], lk_j),
                      jnp.where(l_acc, lkl, lk_j)))
    inc = (is_g, is_g & moved, ~is_g & l_acc)

    kern = PoolISIRMixed(d, np.asarray(prob.y_obs), epsilon=prob.epsilon,
                         sigma=prob._noise_std, global_frequency=gf,
                         batch_size=B, lp_scale=0.35)
    res = resident_from_kde(kde_from_numpy(jkde.X, jkde.weights,
                                           jkde.bandwidth))
    t = torch.from_numpy
    sl_k = (t(sl[0]).permute(1, 2, 0), t(sl[1]).permute(1, 2, 0),
            t(sl[2]).T, t(sl[3]).T)
    noise = MixedNoise(t(nz["g"]), t(nz["u_local"]), t(nz["u_coin"]),
                       t(nz["l1"]), t(nz["l2"]))
    noise = noise._replace(gumbel=torch.cat([noise.gumbel[:, 1:],
                                             noise.gumbel[:, :1]], dim=1))
    (th2, y2, lk2), got_inc = mixed_transition((t(theta), t(y), t(logk)),
                                               sl_k, res, noise, kern.cfg)
    for a, b in zip((th2, y2, lk2), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    for a, b in zip(got_inc, inc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float32))
    assert 0 < float(inc[1].sum()) and 0 < float(inc[2].sum())
