"""The whole-stack coupling flow (K7): the CUDA kernel's wrappers and their
plain torch version.

Port of ``glabc_tpu/ops/pallas/flow_kernel.py`` (``FusedCouplingFlow``,
``flow_push_fused``, ``flow_pull_fused``); the kernel is
``csrc/coupling_flow.cu``.  :class:`FlowPush` runs every layer base ->
data, :class:`FlowPull` data -> base, each returning the transformed
``(dim, N)`` tile and the summed log-scale ``(N,)``.  The weights are the
flow's own stacked parameters, read in place (no packing, no padding of the
feature axis: the card's layout, not the TPU's).  Any ``N``: the kernel
masks its last block.

The plain version is :meth:`CouplingFlow.push_t` / ``pull_t`` under
``no_grad``, per-layer matmuls.  On the card it must run in full float32:
``torch.backends.cuda.matmul.allow_tf32`` is checked to be False.  The
JAX drivers' ``flow_backend`` choice and the bf16-operand variant are not
carried over: on a CUDA tensor the kernel runs, on a CPU tensor the plain
version.
"""

from __future__ import annotations

import torch

__all__ = ["FlowPush", "FlowPull", "flow_push_fused", "flow_pull_fused"]

_ROWS = 64          # the kernel's sub-tile (csrc/coupling_flow.cu kRows)
_MAX_TS = 16        # 2 * (dim // 2) <= 16
_BLOCKS_PER_SM = 2  # rows per block are cut so that the grid fills the card


def _rows_per_block(n: int, num_sms: int, max_rows: int) -> int:
    """Rows per CUDA block: whole 64-row sub-tiles, as many as let the grid
    keep ``_BLOCKS_PER_SM`` blocks per SM busy, at most ``max_rows`` (the
    shared memory bound)."""
    tiles = -(-n // _ROWS)
    want = -(-tiles // (_BLOCKS_PER_SM * num_sms))
    return _ROWS * max(1, min(want, max_rows // _ROWS))


class _CouplingFlowKernel:
    """Shared wrapper of ``csrc/coupling_flow.cu`` for one direction.
    Subclasses keep their own class-level ``launches``, which rises by one
    for every launch of the CUDA kernel and for nothing else."""

    launches = 0
    inverse: bool

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
            return self._launch(flow, x_t)
        if x_t.device.type == "cpu":
            return self.plain(flow, x_t)
        raise ValueError(f"no kernel for device {x_t.device}")

    def plain(self, flow, x_t):
        """The plain torch version on any device: the flow's own per-layer
        transform without gradients, in full float32."""
        self._check(flow, x_t)
        if x_t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the plain flow on the card needs float32 matmuls: set "
                "torch.backends.cuda.matmul.allow_tf32 = False")
        with torch.no_grad():
            out, s = (flow.pull_t(x_t) if self.inverse else flow.push_t(x_t))
        return out.contiguous(), s.contiguous()

    def _launch(self, flow, x_t):
        from ._build import load_library

        d, N = x_t.shape
        H = flow.hidden
        if 2 * (d // 2) > _MAX_TS:
            raise ValueError(f"the CUDA kernel takes dim <= 17, got {d}")
        if H % 8:
            raise ValueError(f"the CUDA kernel takes hidden % 8 == 0, got {H}")
        weights = [w.detach() for w in flow.stack()]
        for name, w in zip(("w0", "b0", "w1", "b1", "w2", "b2"), weights):
            if w.dtype != torch.float32 or not w.is_contiguous():
                raise ValueError(f"{name} must be contiguous float32")
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


class FlowPush(_CouplingFlowKernel):
    """base -> data: ``CouplingFlow.push_t`` (K7-push)."""

    launches = 0
    inverse = False


class FlowPull(_CouplingFlowKernel):
    """data -> base: ``CouplingFlow.pull_t`` (K7-pull)."""

    launches = 0
    inverse = True


def flow_push_fused(flow, z_t):
    """``z_t (dim, N)`` -> ``(x_t (dim, N), sum log s (N,))``: the kernel on
    the card, the plain version on the CPU."""
    return FlowPush().run(flow, z_t)


def flow_pull_fused(flow, x_t):
    """``x_t (dim, N)`` -> ``(z_t (dim, N), sum log s (N,))``."""
    return FlowPull().run(flow, x_t)
