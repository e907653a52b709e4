"""The whole-stack coupling flow (K7): the CUDA kernels' wrappers and their
plain torch version.

Port of ``glabc_tpu/ops/pallas/flow_kernel.py`` (``FusedCouplingFlow``,
``flow_push_fused``, ``flow_pull_fused``).  :class:`FlowPush` runs every
layer base -> data, :class:`FlowPull` data -> base, each returning the
transformed ``(dim, N)`` tile and the summed log-scale ``(N,)``.  Any ``N``:
the kernels mask their last block.

``matmul_dtype`` picks the variant, as in the JAX package:

* ``'float32'`` (the default): ``csrc/coupling_flow.cu``, the conditioner's
  products ``u1 w0`` and ``h0 w1`` on the tensor cores as 3xTF32 splits
  (hi and lo TF32 parts of both operands, three products accumulated in
  float32: a float32 flow), everything else on the FP32 lanes.
  :func:`pack_tf32_weights` splits the weights into the per-layer image
  the kernel copies to shared memory; any hidden width up to 128,
  zero-padded to 32, 64, 96 or 128;
* ``'bfloat16'``: ``csrc/coupling_flow_bf16.cu``, the conditioner's two
  hidden products on the tensor cores by ``wgmma`` with bfloat16 operands
  and float32 accumulation; biases, ReLU, ``exp(+-s)``, the affine update
  and the log-scale sum stay float32.  :func:`pack_bf16_weights` casts the
  weights (JAX's ``pack_flow_weights``) into the per-layer image that the
  kernel copies to shared memory with one bulk copy, its matrices in
  ``wgmma``'s 128-byte-swizzled layout, any hidden width up to 128
  zero-padded to a multiple of 16; :func:`bf16_grid` sizes its blocks
  of 64-row tiles.  It is for proposal densities, which only
  steer importance weights (its log-scale sum is within about 2e-3 of the
  float32 flow's on a 32 x 128 flow), not for training, which
  differentiates the plain float32 flow.

Both take dims up to 17.  Above that, or at hidden widths from 129 to 512,
both dtypes run ``csrc/coupling_flow_wide.cu`` (dims up to 64), which
streams each layer's weights through shared memory in slices
(:func:`pack_wide_weights`, :func:`wide_layout`); its launches count in
``wide_launches`` and ``wide_bf16_launches``.  A zero hidden unit adds
exactly 0, so every image zero-pads the hidden width.  Past these limits a
launch raises ``ValueError``.

The plain version is :meth:`CouplingFlow.push_t` / ``pull_t`` under
``no_grad`` with the same ``matmul_dtype``, per-layer matmuls.  On the card it
must run in full float32: ``torch.backends.cuda.matmul.allow_tf32`` is
checked to be False.  On a CUDA tensor the kernel runs, on a CPU tensor the
plain version.  Each class counts the launches of the float32 kernel in
``launches``, those of the bfloat16 kernel in ``bf16_launches`` and those
of the wide kernel in ``wide_launches`` / ``wide_bf16_launches``.  A
weight image is kept on the flow and made again only after its weights
change, so that a flow pulled thousands of times between two training
steps is packed once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["FlowPush", "FlowPull", "flow_push_fused", "flow_pull_fused",
           "flow_grid", "bf16_grid", "bf16_layer_image", "pack_bf16_weights",
           "pack_tf32_weights", "pack_wide_weights", "wide_layout",
           "kernel_variant", "split_tf32", "tf32_products"]

_MAX_TS = 16        # the weight-resident kernels: 2 * (dim // 2) <= 16
_MAX_DIM = 17
# csrc/coupling_flow_wide.cu: dims and hidden widths up to these; hidden
# units in chunks of 64, each chunk's K-rows of w1 in slices of 32
_WIDE_MAX_DIM = 64
_WIDE_MAX_HIDDEN = 512
_WIDE_NC = 64
_WIDE_KS = 32

_MATMUL_DTYPES = ("float32", "bfloat16")
# csrc/coupling_flow.cu: a warp owns 32-row tiles (two m16 MMA tiles), a
# block up to 8 warps
_TILE = 32
_SMALL_TILE = 16    # the float32 kernel's tile when there are few rows
_MAX_WARPS = 8
_MAX_HIDDEN = 128
# float32 kernel: hidden widths zero-padded to one of these instantiations
_TF32_WIDTHS = (32, 64, 96, 128)
# bf16 kernel (csrc/coupling_flow_bf16.cu): the hidden width is 16 (one
# wgmma k-step) up to 128; a consumer warpgroup owns 64-row tiles; its
# matrices sit in 128-byte swizzled rows of 64 bf16 values, 8 rows an atom
_BF16_TILE = 64
_SW_VALUES = 64
_SW_ATOM = 1024


def _tf32_width(hidden: int) -> int:
    """The float32 weight-resident kernel's padded hidden width, or
    ``ValueError``."""
    if not 1 <= hidden <= _MAX_HIDDEN:
        raise ValueError("the weight-resident float32 kernel takes "
                         f"1 <= hidden <= {_MAX_HIDDEN}, got {hidden}")
    return next(w for w in _TF32_WIDTHS if w >= hidden)


def _bf16_width(hidden: int) -> int:
    """The bf16 kernel's padded hidden width (a multiple of 16, one wgmma
    k-step), or ``ValueError``."""
    if not 1 <= hidden <= _MAX_HIDDEN:
        raise ValueError("the bf16 kernel takes 1 <= hidden <= "
                         f"{_MAX_HIDDEN}, got {hidden}")
    return -(-hidden // 16) * 16


def kernel_variant(dim: int, hidden: int) -> str:
    """Which kernel a launch at ``(dim, hidden)`` takes: ``'resident'``
    (``coupling_flow.cu`` / ``coupling_flow_bf16.cu``, dims up to 17 and
    widths up to 128, as before) or ``'wide'`` (``coupling_flow_wide.cu``,
    dims up to 64 and widths up to 512); ``ValueError`` past both."""
    if not 2 <= dim <= _WIDE_MAX_DIM or not 1 <= hidden <= _WIDE_MAX_HIDDEN:
        raise ValueError(f"the CUDA flow kernels take 2 <= dim <= "
                         f"{_WIDE_MAX_DIM} and 1 <= hidden <= "
                         f"{_WIDE_MAX_HIDDEN}, got dim={dim}, "
                         f"hidden={hidden}")
    if dim <= _MAX_DIM and hidden <= _MAX_HIDDEN:
        return "resident"
    return "wide"


def split_tf32(x: torch.Tensor):
    """``x = hi + lo`` in TF32 pieces, as the float32 kernel splits its
    operands: ``hi`` is ``x`` rounded to TF32 (10 mantissa bits) to nearest
    with ties away from zero (``cvt.rna.tf32.f32``: add 0x1000 to the bits
    and clear the low 13), ``lo`` the remainder ``x - hi`` (exact in
    float32) rounded likewise.  Both float32."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


@functools.lru_cache(maxsize=None)
def _tf32_image_index(d: int, hidden: int, device: str) -> torch.Tensor:
    """Where each float of a layer's image comes from, as an index into
    ``[hi | lo | x]`` of one layer's stacked weights ``x = [w0, b0, w1, b1,
    w2, b2, 0]`` (the layout :func:`pack_tf32_weights` documents); the last
    element of ``x`` is the zero of every pad."""
    d2 = d // 2
    d1, ts = d - d2, 2 * d2
    H, hp = hidden, _tf32_width(hidden)
    nt, nk0 = hp // 8, -(-d1 // 8)
    sizes = [d1 * H, H, H * H, H, H * ts, ts]
    o_w0, o_b0, o_w1, o_b1, o_w2, o_b2 = np.cumsum([0] + sizes[:-1])
    T = sum(sizes) + 1                      # x's length, the zero last
    zero = T - 1

    def at(base, off, row, col, rows, cols):
        ok = (row < rows) & (col < cols)
        return np.where(ok, base + off + row * cols + col, base + zero)

    # B fragments: (k-tile, n-tile, g, t, hi/lo, i)
    kt, n_t, g, t, part, i = np.meshgrid(np.arange(nt), np.arange(nt),
                                         np.arange(8), np.arange(4),
                                         np.arange(2), np.arange(2),
                                         indexing="ij")
    w1 = at(part * T, o_w1, 8 * kt + 2 * t + i, 8 * n_t + g, H, H)
    kk, n_t, g, t, part, i = np.meshgrid(np.arange(nk0), np.arange(nt),
                                         np.arange(8), np.arange(4),
                                         np.arange(2), np.arange(2),
                                         indexing="ij")
    w0 = at(part * T, o_w0, 8 * kk + 4 * i + t, 8 * n_t + g, d1, H)
    raw, n = 2 * T, np.arange(hp)
    b0 = at(raw, o_b0, 0, n, 1, H)
    b1 = at(raw, o_b1, 0, n, 1, H)
    # w2 and b2 with t_j, s_j side by side: column c <- (c % 2) d2 + c // 2
    row, col = np.meshgrid(n, np.arange((ts + 3) & ~3), indexing="ij")
    src = (col % 2) * d2 + col // 2
    w2 = np.where(col < ts, at(raw, o_w2, row, src, H, ts), raw + zero)
    col = np.arange(_MAX_TS)
    b2 = np.where(col < ts, raw + o_b2 + (col % 2) * d2 + col // 2,
                  raw + zero)
    idx = np.concatenate([a.ravel() for a in (w1, w0, b0, b1, w2, b2)])
    return torch.from_numpy(idx).to(device)


def pack_tf32_weights(flow) -> torch.Tensor:
    """The flow's weights as the float32 kernel stages them, one contiguous
    float32 image per layer, ``(L, layer_floats)``, the hidden width
    zero-padded to ``HP`` (:func:`_tf32_width`):

    * ``w1``'s B fragments, hi and lo (:func:`split_tf32`): for each k-tile
      ``kt`` and n-tile ``nt`` of 8, 32 lanes ``4 g + t`` of
      ``{hi(w1[8 kt + 2 t, 8 nt + g]), hi(w1[8 kt + 2 t + 1, 8 nt + g]),
      lo(...), lo(...)}``: the k slots ``t`` and ``t + 4`` of the MMA stand
      for the hidden units ``8 kt + 2 t`` and ``+ 1``, where the kernel's
      ``h0`` C fragment holds them;
    * ``w0``'s B fragments likewise for ``ceil(d1 / 8)`` k-tiles of 8 input
      coordinates (zero from ``d1`` on), lane ``4 g + t`` of n-tile ``nt``
      holding ``{hi(w0[8 kk + t, 8 nt + g]), hi(w0[8 kk + t + 4, 8 nt +
      g]), lo(...), lo(...)}``;
    * ``b0``, ``b1 (HP,)``;
    * ``w2 (HP, ldw2)`` and ``b2 (16,)``, their columns interleaved as
      ``t_0, s_0, t_1, s_1, ...`` and zero-padded (``ldw2`` = ``2 d2``
      rounded up to 4).

    One split and one gather (:func:`_tf32_image_index`), so that a call
    costs a handful of launches on the card."""
    stack = [w.detach() for w in flow.stack()]
    L = stack[0].shape[0]
    x = F.pad(torch.cat([w.reshape(L, -1) for w in stack], dim=1), (0, 1))
    idx = _tf32_image_index(flow.dim, flow.hidden, str(x.device))
    return torch.cat([*split_tf32(x), x], dim=1)[:, idx]


def flow_grid(n: int, num_sms: int, max_sub: int, small_tile: int):
    """``(warps per block, tiles per warp, rows per tile)`` of the float32
    K7 kernel for ``n`` rows.  Few rows (at most 8 tiles of ``small_tile`` rows
    per SM): one tile per warp and as many warps per block as spread the
    tiles over every SM (a warp's MMAs run in sequence, so more warps of
    fewer rows finish sooner).  Above that, 8 warps of 32-row tiles,
    balanced over whole waves of ``num_sms`` blocks, at most ``max_sub``
    (the shared memory bound) per warp.  ``small_tile`` is 16 or 32."""
    small = -(-n // small_tile)
    if small <= _MAX_WARPS * num_sms:
        return -(-small // num_sms), 1, small_tile
    tiles = -(-n // _TILE)
    waves = -(-tiles // (_MAX_WARPS * max_sub * num_sms))
    return (_MAX_WARPS, -(-tiles // (waves * num_sms * _MAX_WARPS)), _TILE)


def bf16_grid(n: int, num_sms: int, max_tiles: int) -> int:
    """64-row tiles per block of the bf16 kernel for ``n`` rows: the tiles
    spread over whole waves of ``num_sms`` blocks (one block fills an SM's
    shared memory), at most ``max_tiles`` (the shared memory bound) a
    block.  With no more tiles than SMs, one a block: the layers of a tile
    run one after another, so the work of few rows is latency, and a tile
    of its own on every SM finishes soonest."""
    tiles = -(-n // _BF16_TILE)
    waves = -(-tiles // (max_tiles * num_sms))
    return -(-tiles // (waves * num_sms))


def _ts_rows(d: int) -> int:
    """Rows of the bf16 kernel's w2 image: ts's 2 (d // 2) columns padded
    to wgmma's n8 or n16."""
    return 8 if d // 2 <= 4 else 16


def bf16_layer_image(d: int, hidden: int) -> dict:
    """Byte offsets of ``w1, w2, w0, b0, b1, b2`` in one layer's image of
    the bf16 kernel, and its size ``bytes`` (``layer_image`` in
    ``csrc/coupling_flow_bf16.cu``)."""
    H, kc, d1 = hidden, -(-hidden // _SW_VALUES), d - d // 2
    o = {"w1": 0}
    o["w2"] = o["w1"] + kc * H * 2 * _SW_VALUES
    o["w0"] = o["w2"] + kc * _ts_rows(d) * 2 * _SW_VALUES
    o["b0"] = o["w0"] + d1 * H * 4
    o["b1"] = o["b0"] + H * 4
    o["b2"] = o["b1"] + H * 4
    o["bytes"] = -(-(o["b2"] + _MAX_TS * 4) // _SW_ATOM) * _SW_ATOM
    return o


def _sw128_index(K: int, rows: int, src):
    """The 128-byte-swizzled K-major image of a matrix with ``rows`` rows
    (the wgmma N side) and ``K`` values a row, as ``src(n, k)``: an index
    array over the image's bf16 slots, ``ceil(K / 64)`` blocks of ``rows``
    rows x 64 values, value ``k`` of row ``n`` in 16-byte chunk
    ``(k % 64 // 8) ^ (n % 8)`` of its row."""
    kc, n, chunk, e = np.meshgrid(np.arange(-(-K // _SW_VALUES)),
                                  np.arange(rows), np.arange(8), np.arange(8),
                                  indexing="ij")
    return src(n, kc * _SW_VALUES + (chunk ^ (n % 8)) * 8 + e)


@functools.lru_cache(maxsize=None)
def _bf16_image_index(d: int, hidden: int, device: str) -> torch.Tensor:
    """Where each bf16 slot of a layer's ``w1`` and ``w2`` images comes
    from, as an index into ``[w1 (H, H), w2 (H, 2 d2), 0]`` flattened; the
    last element is the zero of every pad, hidden units from ``H`` to the
    kernel's width (:func:`_bf16_width`) included."""
    H, d2 = hidden, d // 2
    hp, ts = _bf16_width(hidden), 2 * d2
    zero = H * H + H * ts
    w1 = _sw128_index(hp, hp, lambda n, k: np.where((k < H) & (n < H),
                                                    k * H + n, zero))
    col = lambda n: (n % 2) * d2 + n // 2     # rows t_0, s_0, t_1, s_1, ...
    w2 = _sw128_index(hp, _ts_rows(d), lambda n, k: np.where(
        (k < H) & (n < ts), H * H + k * ts + col(n), zero))
    idx = np.concatenate([w1.ravel(), w2.ravel()])
    return torch.from_numpy(idx).to(device)


def pack_bf16_weights(flow) -> torch.Tensor:
    """The flow's weights as the bf16 kernel stages them, one contiguous byte
    image per layer, ``(L, layer_bytes)`` uint8, at the offsets of
    :func:`bf16_layer_image` for the padded width ``HP`` (:func:`_bf16_width`):
    ``w1`` and ``w2`` in bfloat16 as wgmma's
    K-major operands in the 128-byte swizzle (:func:`_sw128_index`; ``w2``'s
    columns interleaved as ``t_0, s_0, t_1, s_1, ...`` and zero-padded to 8
    or 16), then ``w0 (d1, HP)`` rounded to bfloat16 and held in float32,
    ``b0``, ``b1 (HP,)`` and ``b2`` interleaved and padded to 16, in float32;
    units from ``H`` on zero; the image zero-padded to a multiple of 1,024
    bytes."""
    w0, b0, w1, b1, w2, b2 = (w.detach() for w in flow.stack())
    L, H = w1.shape[0], w1.shape[-1]
    hp = _bf16_width(H)
    d2 = w2.shape[-1] // 2
    ts = 2 * d2
    img = bf16_layer_image(flow.dim, hp)
    x = torch.cat([w1.reshape(L, -1), w2.reshape(L, -1),
                   w1.new_zeros(L, 1)], dim=1).to(torch.bfloat16)
    mats = x[:, _bf16_image_index(flow.dim, H, str(x.device))]
    col = [(c % 2) * d2 + c // 2 for c in range(ts)]
    pad = (0, hp - H)
    floats = torch.cat([F.pad(w0.to(torch.bfloat16).to(torch.float32),
                              pad).reshape(L, -1),
                        F.pad(b0, pad), F.pad(b1, pad),
                        F.pad(b2[:, col], (0, _MAX_TS - ts))], dim=1)
    out = torch.cat([mats.view(torch.uint8), floats.view(torch.uint8)], dim=1)
    return F.pad(out, (0, img["bytes"] - out.shape[1])).contiguous()


def wide_layout(d: int, hidden: int, bf16: bool) -> dict:
    """Float offsets in one layer's image of the wide kernel
    (``wide_image`` in ``csrc/coupling_flow_wide.cu``): the hidden width
    zero-padded to ``HP`` (a multiple of 64); ``slices`` = (HP / 64) x
    (HP / 32) slices of ``sf`` floats, slice ``c HP / 32 + q`` holding the
    ``w1`` fragments of K-rows ``32 q ..`` and columns ``64 c ..`` from 0,
    ``w0`` for hidden units ``32 q ..`` from ``w0`` (float32: fragments,
    ``nk`` k8 steps of u1; bf16: ``(d1, 32)`` floats) and their ``b0`` in
    the last 32; then ``b1 (HP)``, ``w2 (HP, tsp)`` and ``b2 (tsp)``
    (``tsp``: 2 d2 padded to 16)."""
    d2 = d // 2
    d1 = d - d2
    o = {"HP": -(-hidden // _WIDE_NC) * _WIDE_NC, "nk": -(-d1 // 8),
         "tsp": -(-2 * d2 // 16) * 16, "w0": 1024 if bf16 else 4096}
    o["sf"] = o["w0"] + (32 * d1 if bf16 else 512 * o["nk"]) + 32
    o["slices"] = (o["HP"] // _WIDE_NC) * (o["HP"] // _WIDE_KS)
    o["b1"] = o["slices"] * o["sf"]
    o["w2"] = o["b1"] + o["HP"]
    o["b2"] = o["w2"] + o["HP"] * o["tsp"]
    o["floats"] = o["b2"] + o["tsp"]
    return o


def _grid(*sizes):
    return np.meshgrid(*(np.arange(n) for n in sizes), indexing="ij")


@functools.lru_cache(maxsize=None)
def _wide_image_index(d: int, hidden: int, bf16: bool, device: str):
    """Where each slot of a layer's wide image comes from.  float32: an
    index per float into ``[hi | lo | x]`` of one layer's stacked weights
    ``x = [w0, b0, w1, b1, w2, b2, 0]`` (``T`` long, the zero last), as
    :func:`_tf32_image_index`.  bf16: an index per 16-bit half into
    ``[bf16(w1) | halves of x]``, ``H^2 + 1`` bf16 values (the last the
    pad's zero) and then ``x``'s floats as pairs of halves (``x`` with
    ``w0`` and ``w2`` rounded to bf16)."""
    H, d2 = hidden, d // 2
    d1, ts = d - d2, 2 * d2
    o = wide_layout(d, hidden, bf16)
    hp, nk, sf, tsp = o["HP"], o["nk"], o["sf"], o["tsp"]
    nq = hp // _WIDE_KS
    sizes = [d1 * H, H, H * H, H, H * ts, ts]
    o_w0, o_b0, o_w1, o_b1, o_w2, o_b2 = np.cumsum([0] + sizes[:-1])
    T = sum(sizes) + 1
    zero = T - 1
    ok = lambda row, col, rows, cols: (row < rows) & (col < cols)

    def at(base, off, row, col, rows, cols):
        return np.where(ok(row, col, rows, cols),
                        base + off + row * cols + col, base + zero)

    # float slots, as indices into [hi | lo | x] (float32) or x (bf16)
    raw = 0 if bf16 else 2 * T
    fpos, fsrc = [], []
    c, q, i = _grid(hp // _WIDE_NC, nq, 32)
    fpos.append((c * nq + q) * sf + sf - 32 + i)
    fsrc.append(at(raw, o_b0, 0, 32 * q + i, 1, H))
    n = np.arange(hp)
    fpos.append(o["b1"] + n)
    fsrc.append(at(raw, o_b1, 0, n, 1, H))
    row, col = _grid(hp, tsp)
    src = (col % 2) * d2 + col // 2
    fpos.append(o["w2"] + row * tsp + col)
    fsrc.append(np.where(col < ts, at(raw, o_w2, row, src, H, ts), raw + zero))
    col = np.arange(tsp)
    fpos.append(o["b2"] + col)
    fsrc.append(np.where(col < ts, raw + o_b2 + (col % 2) * d2 + col // 2,
                         raw + zero))
    if not bf16:
        idx = np.full(o["floats"], 2 * T + zero, np.int64)
        # w1: (c, q, k-tile j, n-tile, g, t, hi/lo, i): K-row 32 q + 8 j +
        # 2 t + i, column 64 c + 8 nt + g
        c, q, j, nt, g, t, part, i = _grid(hp // _WIDE_NC, nq, 4, 8, 8, 4,
                                           2, 2)
        pos = ((c * nq + q) * sf + (((j * 8 + nt) * 32 + 4 * g + t) * 4
                                    + 2 * part + i))
        idx[pos] = at(part * T, o_w1, 32 * q + 8 * j + 2 * t + i,
                      64 * c + 8 * nt + g, H, H)
        # w0: (c, q, n-tile j, k-tile kk, g, t, hi/lo, i): input 8 kk + t +
        # 4 i, hidden unit 32 q + 8 j + g
        c, q, j, kk, g, t, part, i = _grid(hp // _WIDE_NC, nq, 4, nk, 8, 4,
                                           2, 2)
        pos = ((c * nq + q) * sf + o["w0"]
               + (((j * nk + kk) * 32 + 4 * g + t) * 4 + 2 * part + i))
        idx[pos] = at(part * T, o_w0, 8 * kk + t + 4 * i,
                      32 * q + 8 * j + g, d1, H)
        for p, s_ in zip(fpos, fsrc):
            idx[p] = s_
        return torch.from_numpy(idx).to(device)
    # w0 as (d1, 32) floats a slice: input kk, hidden unit 32 q + i
    c, q, kk, i = _grid(hp // _WIDE_NC, nq, d1, 32)
    fpos.append((c * nq + q) * sf + o["w0"] + kk * 32 + i)
    fsrc.append(at(raw, o_w0, kk, 32 * q + i, d1, H))
    nb = H * H + 1                          # bf16 values, the zero last
    bzero = nb - 1
    idx = np.full(2 * o["floats"], bzero, np.int64)
    # w1 halves: (c, q, k-step j, n-tile, g, t, register r, half h): K-row
    # 32 q + 16 j + 2 t + 8 r + h, column 64 c + 8 nt + g
    c, q, j, nt, g, t, r, h = _grid(hp // _WIDE_NC, nq, 2, 8, 8, 4, 2, 2)
    pos = (2 * (c * nq + q) * sf
           + (((j * 8 + nt) * 32 + 4 * g + t) * 2 + r) * 2 + h)
    k, n = 32 * q + 16 * j + 2 * t + 8 * r + h, 64 * c + 8 * nt + g
    idx[pos] = np.where(ok(k, n, H, H), k * H + n, bzero)
    for p, s_ in zip(fpos, fsrc):
        idx[2 * p] = nb + 2 * s_
        idx[2 * p + 1] = nb + 2 * s_ + 1
    return torch.from_numpy(idx).to(device)


def pack_wide_weights(flow, bf16: bool = False) -> torch.Tensor:
    """The flow's weights as the wide kernel streams them, one contiguous
    float32 image per layer, ``(L, floats)`` at the offsets of
    :func:`wide_layout`:

    * float32: ``w1``'s B fragments of m16n8k8, hi and lo
      (:func:`split_tf32`), lane ``4 g + t`` of k-tile ``j`` and n-tile
      ``nt`` holding ``{hi(w1[k, n]), hi(w1[k + 1, n]), lo(...), lo(...)}``
      at ``k = 32 q + 8 j + 2 t``, ``n = 64 c + 8 nt + g`` (the k slots ``t``
      and ``t + 4`` stand for units ``k`` and ``k + 1``, where the h0 C
      fragment holds them, as in :func:`pack_tf32_weights`); ``w0``'s for
      n-tile ``j`` (units ``32 q + 8 j + g``) and k-tile ``kk`` of u1:
      ``{hi(w0[8 kk + t, u]), hi(w0[8 kk + t + 4, u]), lo, lo}``;
    * bf16: ``w1``'s B fragments of m16n8k16 in bfloat16, two words a lane
      of k-step ``j`` and n-tile ``nt``: ``{w1[k, n], w1[k + 1, n]}`` and
      ``{w1[k + 8, n], w1[k + 9, n]}`` at ``k = 32 q + 16 j + 2 t``;
      ``w0[kk, 32 q + i]`` as a ``(d1, 32)`` block; ``w0`` and ``w2``
      rounded to bfloat16 and held in float32;
    * then ``b0`` (32 a slice), ``b1``, ``w2 (HP, tsp)`` and ``b2`` in
      float32, ``w2``'s and ``b2``'s columns interleaved as ``t_0, s_0,
      t_1, s_1, ...``; every pad zero."""
    stack = [w.detach() for w in flow.stack()]
    L = stack[0].shape[0]
    if bf16:
        for i in (0, 4):
            stack[i] = stack[i].to(torch.bfloat16).to(torch.float32)
    x = F.pad(torch.cat([w.reshape(L, -1) for w in stack], dim=1), (0, 1))
    idx = _wide_image_index(flow.dim, flow.hidden, bool(bf16), str(x.device))
    if not bf16:
        return torch.cat([*split_tf32(x), x], dim=1)[:, idx].contiguous()
    w1 = stack[2].reshape(L, -1)
    halves = torch.cat([F.pad(w1, (0, 1)).to(torch.bfloat16)
                        .view(torch.int16), x.view(torch.int16)], dim=1)
    return halves[:, idx].contiguous().view(torch.float32)


def _image(flow, pack):
    """``pack(flow)``, kept on the flow until one of its weights changes:
    another tensor, other storage or an in-place write to it (an optimizer
    step bumps its ``_version``; a write through ``.data`` does not, and is
    not seen).  The entry holds the weights themselves, so that a replaced
    tensor cannot hand its address to a new one while the entry names
    it."""
    key = tuple((w, w.data_ptr(), w._version) for w in flow.stack())
    cache = flow.__dict__.setdefault("_kernel_images", {})
    hit = cache.get(pack)
    if hit is None or any(a is not b or pa != pb or va != vb
                          for (a, pa, va), (b, pb, vb) in zip(hit[0], key)):
        hit = cache[pack] = (key, pack(flow))
    return hit[1]


def tf32_products(flow, x_t, inverse: bool, split: bool = True):
    """The float32 flow with each layer's hidden product ``h0 w1`` taken
    from TF32 pieces (:func:`split_tf32`) as a tensor-core kernel takes it:
    the three split products ``lo hi + hi lo + hi hi`` (``split``, the
    float32 kernel's design) or ``hi hi`` alone (one TF32 product); every
    other step as in :meth:`CouplingFlow.push_t` / ``pull_t``.  Each
    product of TF32 pieces is exact in float32, so the float32 matmuls
    compute what the tensor cores do up to the order of the sums.  It shows
    which limit against the float32 flow tells the split kernel from a
    single-product one.  ``(out (dim, N), sum of the log-scales (N,))``."""
    if x_t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("tf32_products on the card needs float32 matmuls: "
                           "set torch.backends.cuda.matmul.allow_tf32 = False")
    w0, b0, w1, b1, w2, b2 = (w.detach() for w in flow.stack())
    d2 = flow.dim // 2
    d1 = flow.dim - d2
    u = x_t.T
    acc = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    for step in range(flow.n_layers):
        l = flow.n_layers - 1 - step if inverse else step
        u1 = u[:, d2:] if inverse else u[:, :d1]
        ah, al = split_tf32(torch.relu(u1 @ w0[l] + b0[l]))
        bh, bl = split_tf32(w1[l])
        prod = al @ bh + ah @ bl + ah @ bh if split else ah @ bh
        ts = torch.relu(prod + b1[l]) @ w2[l] + b2[l]
        t, s = ts[:, :d2], ts[:, d2:]
        if inverse:
            u = torch.cat([u1, (u[:, :d2] - t) * torch.exp(-s)], dim=1)
        else:
            u = torch.cat([u[:, d1:] * torch.exp(s) + t, u1], dim=1)
        acc = acc + s.sum(dim=1)
    return u.T.contiguous(), acc


class _CouplingFlowKernel:
    """Shared wrapper of the K7 kernels for one direction.  Subclasses
    keep their own class-level ``launches`` (the float32 kernel),
    ``bf16_launches`` (the bfloat16 kernel), ``wide_launches`` and
    ``wide_bf16_launches`` (the wide kernel in float32 and bf16), each of
    which rises by one for every launch of that CUDA kernel and for nothing
    else."""

    launches = 0
    bf16_launches = 0
    wide_launches = 0
    wide_bf16_launches = 0
    inverse: bool

    def __init__(self, matmul_dtype: str = "float32"):
        if matmul_dtype not in _MATMUL_DTYPES:
            raise ValueError(f"matmul_dtype must be one of {_MATMUL_DTYPES}, "
                             f"got {matmul_dtype!r}")
        self.matmul_dtype = matmul_dtype

    def _check(self, flow, x_t):
        if not isinstance(x_t, torch.Tensor):
            raise TypeError("x_t must be a torch.Tensor")
        if x_t.dtype != torch.float32:
            raise TypeError(f"x_t must be float32, got {x_t.dtype}")
        if not x_t.is_contiguous():
            raise ValueError("x_t must be contiguous")
        if x_t.dim() != 2 or x_t.shape[0] != flow.dim or x_t.shape[1] < 1:
            raise ValueError(f"x_t must be ({flow.dim}, N), got "
                             f"{tuple(x_t.shape)}")
        if x_t.device != flow.loc.device:
            raise ValueError(f"x_t is on {x_t.device}, the flow on "
                             f"{flow.loc.device}")

    def run(self, flow, x_t):
        """The flow over every layer of ``x_t (dim, N)``: ``(out (dim, N),
        sum of the log-scales (N,))``."""
        self._check(flow, x_t)
        if x_t.device.type == "cpu":
            return self.plain(flow, x_t)
        if kernel_variant(flow.dim, flow.hidden) == "wide":
            return self._launch_wide(flow, x_t)
        if self.matmul_dtype == "bfloat16":
            return self._launch_bf16(flow, x_t)
        return self._launch(flow, x_t)

    def plain(self, flow, x_t):
        """The plain torch version on any device: the flow's own per-layer
        transform without gradients, with float32 matmuls (on bfloat16-rounded
        operands for ``matmul_dtype='bfloat16'``)."""
        self._check(flow, x_t)
        if x_t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the plain flow on the card needs float32 matmuls: set "
                "torch.backends.cuda.matmul.allow_tf32 = False")
        with torch.no_grad():
            out, s = (flow.pull_t(x_t, self.matmul_dtype) if self.inverse
                      else flow.push_t(x_t, self.matmul_dtype))
        return out.contiguous(), s.contiguous()

    def _check_launch(self, flow, x_t):
        """The checks of a launch after the kernel's own shape checks: the
        weights' type and layout, and a CUDA device."""
        for name, w in zip(("w0", "b0", "w1", "b1", "w2", "b2"),
                           flow.stack()):
            if w.dtype != torch.float32 or not w.is_contiguous():
                raise ValueError(f"{name} must be contiguous float32")
        if x_t.device.type != "cuda":
            raise ValueError(f"no kernel for device {x_t.device}")

    def _launch(self, flow, x_t):
        from ._build import load_library

        d, N = x_t.shape
        if d > _MAX_DIM:
            raise ValueError(f"the float32 kernel takes dim <= {_MAX_DIM}, "
                             f"got {d}")
        hp = _tf32_width(flow.hidden)
        self._check_launch(flow, x_t)
        lib = load_library("coupling_flow")
        dev = x_t.device
        with torch.cuda.device(dev):
            max_sub = lib.glabc_coupling_flow_max_sub(d, hp, _MAX_WARPS,
                                                      _TILE)
            if max_sub < 1:
                raise ValueError(f"hidden={flow.hidden} at dim={d} does not "
                                 "fit the kernel's shared memory")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            warps, nsub, rows = flow_grid(N, sms, max_sub, _SMALL_TILE)
            packed = _image(flow, pack_tf32_weights)
            out = torch.empty_like(x_t)
            s = torch.empty(N, dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.glabc_coupling_flow(
                x_t.data_ptr(), out.data_ptr(), s.data_ptr(),
                packed.data_ptr(), d, N, flow.n_layers, hp, int(self.inverse),
                warps, nsub, rows, stream)
        if rc != 0:
            raise RuntimeError(f"coupling_flow launch failed: CUDA error {rc}")
        type(self).launches += 1
        return out, s

    def _launch_bf16(self, flow, x_t):
        from ._build import load_library

        d, N = x_t.shape
        if d > _MAX_DIM:
            raise ValueError(f"the bf16 kernel takes dim <= {_MAX_DIM}, got "
                             f"{d}")
        hp = _bf16_width(flow.hidden)
        self._check_launch(flow, x_t)
        lib = load_library("coupling_flow_bf16")
        dev = x_t.device
        with torch.cuda.device(dev):
            max_tiles = lib.glabc_coupling_flow_bf16_max_tiles(d, hp)
            if max_tiles < 1:
                raise ValueError(f"hidden={flow.hidden} at dim={d} does not "
                                 "fit the bf16 kernel's shared memory")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            ntiles = bf16_grid(N, sms, max_tiles)
            packed = _image(flow, pack_bf16_weights)
            if packed.shape[1] != lib.glabc_coupling_flow_bf16_layer_bytes(
                    d, hp):
                raise RuntimeError("pack_bf16_weights and the bf16 kernel "
                                   "disagree on the layer image's size")
            out = torch.empty_like(x_t)
            s = torch.empty(N, dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.glabc_coupling_flow_bf16(
                x_t.data_ptr(), out.data_ptr(), s.data_ptr(),
                packed.data_ptr(), d, N, flow.n_layers, hp, int(self.inverse),
                ntiles, stream)
        if rc != 0:
            raise RuntimeError("coupling_flow_bf16 launch failed: CUDA error "
                               f"{rc}")
        type(self).bf16_launches += 1
        return out, s

    def _launch_wide(self, flow, x_t):
        """``csrc/coupling_flow_wide.cu``: one tile of 16 or 32 rows a warp
        (:func:`flow_grid` with one tile a warp), the weights streamed."""
        from ._build import load_library

        d, N = x_t.shape
        H, bf16 = flow.hidden, self.matmul_dtype == "bfloat16"
        self._check_launch(flow, x_t)
        lib = load_library("coupling_flow_wide")
        dev = x_t.device
        with torch.cuda.device(dev):
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            warps, _, rows = flow_grid(N, sms, 1, _SMALL_TILE)
            pack = _pack_wide_bf16 if bf16 else pack_wide_weights
            packed = _image(flow, pack)
            if packed.shape[1] != lib.glabc_coupling_flow_wide_layer_floats(
                    d, H, int(bf16)):
                raise RuntimeError("pack_wide_weights and the wide kernel "
                                   "disagree on the layer image's size")
            out = torch.empty_like(x_t)
            s = torch.empty(N, dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.glabc_coupling_flow_wide(
                x_t.data_ptr(), out.data_ptr(), s.data_ptr(),
                packed.data_ptr(), d, N, flow.n_layers, H, int(self.inverse),
                int(bf16), warps, rows, stream)
        if rc != 0:
            raise RuntimeError(f"coupling_flow_wide launch failed: CUDA error "
                               f"{rc}")
        if bf16:
            type(self).wide_bf16_launches += 1
        else:
            type(self).wide_launches += 1
        return out, s


def _pack_wide_bf16(flow) -> torch.Tensor:
    return pack_wide_weights(flow, bf16=True)


class FlowPush(_CouplingFlowKernel):
    """base -> data: ``CouplingFlow.push_t`` (K7-push, K7-bf16-push)."""

    launches = 0
    bf16_launches = 0
    wide_launches = 0
    wide_bf16_launches = 0
    inverse = False


class FlowPull(_CouplingFlowKernel):
    """data -> base: ``CouplingFlow.pull_t`` (K7-pull, K7-bf16-pull)."""

    launches = 0
    bf16_launches = 0
    wide_launches = 0
    wide_bf16_launches = 0
    inverse = True


def flow_push_fused(flow, z_t, *, matmul_dtype: str = "float32"):
    """``z_t (dim, N)`` -> ``(x_t (dim, N), sum log s (N,))``: the kernel on
    the card, the plain version on the CPU; ``matmul_dtype='bfloat16'`` takes
    the conditioner's products in bfloat16."""
    return FlowPush(matmul_dtype).run(flow, z_t)


def flow_pull_fused(flow, x_t, *, matmul_dtype: str = "float32"):
    """``x_t (dim, N)`` -> ``(z_t (dim, N), sum log s (N,))``."""
    return FlowPull(matmul_dtype).run(flow, x_t)
