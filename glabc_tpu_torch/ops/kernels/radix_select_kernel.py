"""Exact order statistics of a float32 array by radix select: a pass's
digit histograms and digit pick (K11) as CUDA kernels with their plain torch
versions, and the select built on them.

The kernels are ``csrc/radix_select.cu``; they replace no kernel of the
JAX package, whose quantile is ``jnp.sort`` under XLA.  The select serves
the chain-sharded AGLMCMC epoch (``parallel/sharded.py``
``distributed_quantile``): each pass's histograms are summed over the ranks
(``combine``) in place of gathering every rank's values, so the select
exchanges ``2 x 2^bits`` counts a pass.

Values map to order-preserving 32-bit keys (:func:`order_keys`): -0.0 reads
as +0.0 and every NaN as ``0xFFFFFFFF``, so the keys order the values as
``torch.sort`` does, NaNs last.  :func:`radix_select` finds the keys at two
ranks in ``len(DIGITS)`` passes, most significant digit first, entirely on
the tensors' device: the prefixes and ranks are a state tensor there, and no
pass reads anything back to the host.
"""

from __future__ import annotations

import torch

__all__ = ["DIGITS", "RadixSelect", "order_keys", "key_values",
           "radix_select"]

DIGITS = (11, 11, 10)     # bits a pass, most significant first; sum 32
_MAX_BITS = 11            # csrc/radix_select.cu: 2 x 2^bits shared counters
_SIGN = 1 << 31
_ONES = (1 << 32) - 1


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """The order-preserving keys of float32 ``x``, flattened, as int64 in
    ``[0, 2^32)``: the sign bit flipped for ``x >= 0``, every bit for
    ``x < 0``; -0.0 as +0.0, a NaN as ``2^32 - 1``."""
    x = x.reshape(-1).to(torch.float32)
    x = torch.where(x == 0, torch.zeros_like(x), x)
    u = x.view(torch.int32).to(torch.int64) & _ONES
    key = torch.where(u >= _SIGN, _ONES - u, u + _SIGN)
    return torch.where(torch.isnan(x), torch.full_like(key, _ONES), key)


def key_values(keys: torch.Tensor) -> torch.Tensor:
    """The float32 values of int64 ``keys`` (:func:`order_keys`' inverse,
    but for the sign of a zero and a NaN's payload)."""
    u = torch.where(keys >= _SIGN, keys - _SIGN, _ONES - keys)
    u = torch.where(u >= _SIGN, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


class RadixSelect:
    """The two steps of a radix-select pass, on a state ``(4,)`` int64 on
    the values' device: the targets' prefixes so far, then their ranks
    among the keys under those prefixes.

    * ``hist(x, state, shift, bits, out) -> out`` adds to ``out (2,
      2^bits)`` int64, for each target ``t``, the histogram of digit ``(key
      >> shift) & (2^bits - 1)`` over the keys of ``x`` (float32, 1-D) with
      ``key >> (shift + bits) == state[t]``;
    * ``pick(hist, state, bits, values=None) -> state`` takes each target's
      digit from its complete histogram, the first whose cumulative count
      exceeds its rank (the last if none does), in place: the rank less the
      counts below the digit, the prefix with the digit appended; into
      ``values (2,)`` float32, where given, the new prefixes' values.

    ``launches`` counts launches of the CUDA histogram kernel and
    ``pick_launches`` of the pick (class-wide); each rises for nothing
    else."""

    launches = 0
    pick_launches = 0

    @staticmethod
    def _check(bits, state, **tensors):
        dev = state.device
        want = {"x": torch.float32, "out": torch.int64, "hist": torch.int64,
                "values": torch.float32}
        for name, t in (("state", state), *tensors.items()):
            if t is None and name == "values":
                continue
            dtype = want.get(name, torch.int64)
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"{name} must be a torch.Tensor")
            if t.dtype != dtype:
                raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, state on {dev}")
        if not 1 <= bits <= _MAX_BITS:
            raise ValueError(f"a digit of 1..{_MAX_BITS} bits, got {bits}")
        shapes = {"state": (4,), "out": (2, 1 << bits),
                  "hist": (2, 1 << bits), "values": (2,)}
        for name, t in (("state", state), *tensors.items()):
            if name == "x":
                if t.dim() != 1:
                    raise ValueError(f"x must be 1-D, got {tuple(t.shape)}")
            elif t is not None and tuple(t.shape) != shapes[name]:
                raise ValueError(f"{name} must be {shapes[name]}, got "
                                 f"{tuple(t.shape)}")

    def hist(self, x, state, shift: int, bits: int, out) -> torch.Tensor:
        self._check(bits, state, x=x, out=out)
        if shift < 0 or shift + bits > 32:
            raise ValueError(f"a digit within 32 bits, got shift={shift}, "
                             f"bits={bits}")
        if x.device.type == "cpu":
            return self.plain_hist(x, state, shift, bits, out)
        if x.device.type != "cuda":
            raise ValueError(f"no kernel for device {x.device}")
        if x.numel() == 0:
            return out
        rc = self._lib().glabc_radix_select_hist(
            x.data_ptr(), x.numel(), state.data_ptr(), out.data_ptr(), shift,
            bits, self._stream(x))
        self._raise(rc)
        RadixSelect.launches += 1
        return out

    def pick(self, hist, state, bits: int, values=None) -> torch.Tensor:
        self._check(bits, state, hist=hist, values=values)
        if state.device.type == "cpu":
            return self.plain_pick(hist, state, bits, values)
        if state.device.type != "cuda":
            raise ValueError(f"no kernel for device {state.device}")
        rc = self._lib().glabc_radix_select_pick(
            hist.data_ptr(), state.data_ptr(), bits,
            None if values is None else values.data_ptr(),
            self._stream(state))
        self._raise(rc)
        RadixSelect.pick_launches += 1
        return state

    def plain_hist(self, x, state, shift: int, bits: int,
                   out) -> torch.Tensor:
        """The plain torch version of :meth:`hist`, on any device."""
        keys = order_keys(x)
        digit = (keys >> shift) & ((1 << bits) - 1)
        high = keys >> (shift + bits)
        for t in range(2):
            out[t].scatter_add_(0, digit, (high == state[t]).to(torch.int64))
        return out

    def plain_pick(self, hist, state, bits: int,
                   values=None) -> torch.Tensor:
        """The plain torch version of :meth:`pick`, on any device."""
        cum = torch.cumsum(hist, dim=1)
        k = state[2:]
        digit = torch.clamp(torch.sum(cum <= k[:, None], dim=1),
                            max=(1 << bits) - 1)
        below = torch.gather(cum, 1, torch.clamp(digit - 1, min=0)[:, None])
        below = torch.where(digit > 0, below[:, 0], torch.zeros_like(k))
        state[2:] = k - below
        state[:2] = state[:2] * (1 << bits) + digit
        if values is not None:
            values.copy_(key_values(state[:2]))
        return state

    @staticmethod
    def _lib():
        from ._build import load_library

        return load_library("radix_select")

    @staticmethod
    def _stream(t):
        with torch.cuda.device(t.device):
            return torch.cuda.current_stream(t.device).cuda_stream

    @staticmethod
    def _raise(rc):
        if rc != 0:
            raise RuntimeError(f"radix_select launch failed: CUDA error {rc}")


def radix_select(x: torch.Tensor, k: torch.Tensor,
                 combine=None) -> torch.Tensor:
    """The values at the 0-based ranks ``k (2,)`` (int64, on ``x``'s
    device) of float32 ``x`` sorted as ``torch.sort`` sorts it, NaNs last:
    ``(2,)`` float32, but +0.0 for a zero of either sign and one NaN for
    any.  ``combine``, where given, maps each pass's ``(2, 2^bits)`` int64
    histograms, which it may overwrite, before the digits are picked (on a
    mesh: their sum over the ranks, ``x`` this rank's shard and ``k`` ranks
    in the joined array).  One histogram launch and one pick a pass."""
    x = x.reshape(-1).contiguous()
    kern = RadixSelect()
    k = k.to(torch.int64)
    state = torch.cat([torch.zeros_like(k), k])
    hists = torch.zeros(sum(2 << b for b in DIGITS), dtype=torch.int64,
                        device=x.device)
    values = torch.empty(2, dtype=torch.float32, device=x.device)
    shift, off = 32, 0
    for i, bits in enumerate(DIGITS):
        shift -= bits
        hist = hists[off:off + (2 << bits)].view(2, 1 << bits)
        off += 2 << bits
        kern.hist(x, state, shift, bits, hist)
        if combine is not None:
            hist = combine(hist)
        kern.pick(hist, state, bits, values if i == len(DIGITS) - 1 else None)
    return values
