"""The whole-stack coupling flow (K7): the CUDA kernels' wrappers and their
plain torch version.

Port of ``glabc_tpu/ops/pallas/flow_kernel.py`` (``FusedCouplingFlow``,
``flow_push_fused``, ``flow_pull_fused``).  :class:`FlowPush` runs every
layer base -> data, :class:`FlowPull` data -> base, each returning the
transformed ``(dim, N)`` tile and the summed log-scale ``(N,)``.  Any ``N``:
the kernels mask their last block.

``matmul_dtype`` picks the variant, as in the JAX package:

* ``'float32'`` (the default): ``csrc/coupling_flow.cu``, FP32 products,
  reading the flow's stacked parameters in place (no packing, no padding of
  the feature axis: the card's layout, not the TPU's);
* ``'bfloat16'``: ``csrc/coupling_flow_bf16.cu``, the conditioner's three
  products on the tensor cores with bfloat16 operands and float32
  accumulation; biases, ReLU, ``exp(+-s)``, the affine update and the
  log-scale sum stay float32.  :func:`pack_bf16_weights` casts the weights
  once per call (JAX's ``pack_flow_weights``) into the per-layer image the
  kernel copies to shared memory.  It is for proposal densities, which only
  steer importance weights (its log-scale sum is within about 2e-3 of the
  float32 flow's on a 32 x 128 flow), not for training, which
  differentiates the plain float32 flow.

The plain version is :meth:`CouplingFlow.push_t` / ``pull_t`` under
``no_grad`` with the same ``matmul_dtype``, per-layer matmuls.  On the card it
must run in full float32: ``torch.backends.cuda.matmul.allow_tf32`` is
checked to be False.  On a CUDA tensor the kernel runs, on a CPU tensor the
plain version.  Each class counts the launches of the float32 kernel in
``launches`` and those of the bfloat16 kernel in ``bf16_launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["FlowPush", "FlowPull", "flow_push_fused", "flow_pull_fused",
           "pack_bf16_weights"]

_ROWS = 64          # the kernel's sub-tile (csrc/coupling_flow.cu kRows)
_MAX_TS = 16        # 2 * (dim // 2) <= 16
_BLOCKS_PER_SM = 2  # rows per block are cut so that the grid fills the card

_MATMUL_DTYPES = ("float32", "bfloat16")
# csrc/coupling_flow_bf16.cu: a warp owns 32-row tiles (two m16 MMA tiles), a
# block up to 8 warps; the hidden width is 16 (one MMA k-tile) up to 128
_BF16_TILE = 32
_BF16_MAX_WARPS = 8
_BF16_MAX_HIDDEN = 128
_BF16_LDW1 = 8      # bf16 pad of each w1 row in shared memory (ldmatrix banks)
_BF16_LDW2 = 24     # bf16 row of w2 in shared memory: 2*d2 <= 16, padded


def _rows_per_block(n: int, num_sms: int, max_rows: int) -> int:
    """Rows per CUDA block: whole 64-row sub-tiles, as many as let the grid
    keep ``_BLOCKS_PER_SM`` blocks per SM busy, at most ``max_rows`` (the
    shared memory bound)."""
    tiles = -(-n // _ROWS)
    want = -(-tiles // (_BLOCKS_PER_SM * num_sms))
    return _ROWS * max(1, min(want, max_rows // _ROWS))


def bf16_grid(n: int, num_sms: int, max_sub: int):
    """``(warps per block, 32-row tiles per warp)`` of the bf16 kernel for
    ``n`` rows: below a full wave of 8-warp blocks, one tile per warp and as
    many warps per block as spread the tiles over every SM; above it, 8
    warps and the tiles balanced over whole waves of ``num_sms`` blocks, at
    most ``max_sub`` (the shared memory bound) per warp."""
    tiles = -(-n // _BF16_TILE)
    if tiles < _BF16_MAX_WARPS * num_sms:
        warps = 1
        while warps * 2 <= _BF16_MAX_WARPS and warps * 2 * num_sms <= tiles:
            warps *= 2
        return warps, 1
    per_block = _BF16_MAX_WARPS * max_sub
    waves = -(-tiles // (per_block * num_sms))
    blocks = waves * num_sms
    return _BF16_MAX_WARPS, max(1, min(max_sub, -(-tiles // (
        blocks * _BF16_MAX_WARPS))))


def pack_bf16_weights(flow) -> torch.Tensor:
    """The flow's weights as the bf16 kernel stages them, one contiguous byte
    image per layer, ``(L, layer_bytes)`` uint8: ``w1 (H, H + 8)`` and ``w2
    (H, 24)`` in bfloat16 (zero-padded columns), ``w0 (d1, H)`` rounded to
    bfloat16 and held in float32, then ``b0``, ``b1 (H,)`` and ``b2`` padded
    to 16, in float32."""
    w0, b0, w1, b1, w2, b2 = (w.detach() for w in flow.stack())
    L, H = w1.shape[0], w1.shape[-1]
    ts = w2.shape[-1]
    parts = [
        F.pad(w1.to(torch.bfloat16), (0, _BF16_LDW1)),
        F.pad(w2.to(torch.bfloat16), (0, _BF16_LDW2 - ts)),
        w0.to(torch.bfloat16).to(torch.float32),
        b0, b1, F.pad(b2, (0, _MAX_TS - ts)),
    ]
    return torch.cat([p.contiguous().reshape(L, -1).view(torch.uint8)
                      for p in parts], dim=1)


class _CouplingFlowKernel:
    """Shared wrapper of the two K7 kernels for one direction.  Subclasses
    keep their own class-level ``launches`` (the float32 kernel) and
    ``bf16_launches`` (the bfloat16 kernel), which rise by one for every
    launch of that CUDA kernel and for nothing else."""

    launches = 0
    bf16_launches = 0
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
        if x_t.device.type == "cuda":
            if self.matmul_dtype == "bfloat16":
                return self._launch_bf16(flow, x_t)
            return self._launch(flow, x_t)
        if x_t.device.type == "cpu":
            return self.plain(flow, x_t)
        raise ValueError(f"no kernel for device {x_t.device}")

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

    def _weights(self, flow):
        weights = [w.detach() for w in flow.stack()]
        for name, w in zip(("w0", "b0", "w1", "b1", "w2", "b2"), weights):
            if w.dtype != torch.float32 or not w.is_contiguous():
                raise ValueError(f"{name} must be contiguous float32")
        return weights

    def _launch(self, flow, x_t):
        from ._build import load_library

        d, N = x_t.shape
        H = flow.hidden
        if 2 * (d // 2) > _MAX_TS:
            raise ValueError(f"the CUDA kernel takes dim <= 17, got {d}")
        if H % 8:
            raise ValueError(f"the CUDA kernel takes hidden % 8 == 0, got {H}")
        weights = self._weights(flow)
        lib = load_library("coupling_flow")
        dev = x_t.device
        with torch.cuda.device(dev):
            max_rows = lib.glabc_coupling_flow_max_rows(d, H)
            if max_rows < _ROWS:
                raise ValueError(f"hidden={H} at dim={d} does not fit the "
                                 "kernel's shared memory")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            rows = _rows_per_block(N, sms, max_rows)
            out = torch.empty_like(x_t)
            s = torch.empty(N, dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.glabc_coupling_flow(
                x_t.data_ptr(), out.data_ptr(), s.data_ptr(),
                *(w.data_ptr() for w in weights), d, N, flow.n_layers, H,
                int(self.inverse), rows // _ROWS, stream)
        if rc != 0:
            raise RuntimeError(f"coupling_flow launch failed: CUDA error {rc}")
        type(self).launches += 1
        return out, s

    def _launch_bf16(self, flow, x_t):
        from ._build import load_library

        d, N = x_t.shape
        H = flow.hidden
        if 2 * (d // 2) > _MAX_TS:
            raise ValueError(f"the bf16 kernel takes dim <= 17, got {d}")
        if H % 16 or not 16 <= H <= _BF16_MAX_HIDDEN:
            raise ValueError("the bf16 kernel takes hidden % 16 == 0 and "
                             f"16 <= hidden <= {_BF16_MAX_HIDDEN}, got {H}")
        self._weights(flow)
        lib = load_library("coupling_flow_bf16")
        dev = x_t.device
        with torch.cuda.device(dev):
            max_sub = lib.glabc_coupling_flow_bf16_max_sub(d, H,
                                                           _BF16_MAX_WARPS)
            if max_sub < 1:
                raise ValueError(f"hidden={H} at dim={d} does not fit the "
                                 "bf16 kernel's shared memory")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            warps, nsub = bf16_grid(N, sms, max_sub)
            packed = pack_bf16_weights(flow)
            out = torch.empty_like(x_t)
            s = torch.empty(N, dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.glabc_coupling_flow_bf16(
                x_t.data_ptr(), out.data_ptr(), s.data_ptr(),
                packed.data_ptr(), d, N, flow.n_layers, H, int(self.inverse),
                warps, nsub, stream)
        if rc != 0:
            raise RuntimeError("coupling_flow_bf16 launch failed: CUDA error "
                               f"{rc}")
        type(self).bf16_launches += 1
        return out, s


class FlowPush(_CouplingFlowKernel):
    """base -> data: ``CouplingFlow.push_t`` (K7-push, K7-bf16-push)."""

    launches = 0
    bf16_launches = 0
    inverse = False


class FlowPull(_CouplingFlowKernel):
    """data -> base: ``CouplingFlow.pull_t`` (K7-pull, K7-bf16-pull)."""

    launches = 0
    bf16_launches = 0
    inverse = True


def flow_push_fused(flow, z_t, *, matmul_dtype: str = "float32"):
    """``z_t (dim, N)`` -> ``(x_t (dim, N), sum log s (N,))``: the kernel on
    the card, the plain version on the CPU; ``matmul_dtype='bfloat16'`` takes
    the conditioner's products in bfloat16."""
    return FlowPush(matmul_dtype).run(flow, z_t)


def flow_pull_fused(flow, x_t, *, matmul_dtype: str = "float32"):
    """``x_t (dim, N)`` -> ``(z_t (dim, N), sum log s (N,))``."""
    return FlowPull(matmul_dtype).run(flow, x_t)
