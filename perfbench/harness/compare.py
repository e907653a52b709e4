"""Comparisons that decide ``correct``, shared by the entries."""

from __future__ import annotations

import torch


def mismatch_share(got_th, got_c, want_th, want_c, tol=1e-5) -> float:
    """Share of rows whose theta differs from the reference's by more than
    ``tol max(1, |theta|)``, is not finite, or whose counters differ."""
    bad = ((got_th - want_th).abs() > tol * torch.clamp_min(
        want_th.abs(), 1.0)).any(dim=-1) | ~torch.isfinite(got_th).all(-1)
    for g, w in zip(got_c, want_c):
        bad |= g.to(torch.int64) != w.to(torch.int64)
    return float(bad.to(torch.float64).mean()) if bad.numel() else 0.0
