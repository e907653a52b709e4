"""Weighted Gaussian-product kernel density estimator in torch.

Port of ``glabc_tpu/models/kde.py`` (reference ``glabcmcmc/
kernel_density.py``: fit :70, log_prob :96, sample :130, forward :158).
Where the JAX package vmaps one KDE per chain, a :class:`KernelDensity`
here carries any leading (chain) axes itself: ``X (..., n, d)``,
``weights (..., n)``, ``bandwidth (..., d)``.  Unbatched, it is the shared
KDE of AGLMCMC's cross-chain adaptation.

As in the JAX package: masked rows (weight 0) keep static shapes, the
Silverman bandwidth counts only positive-weight rows, and ``log_prob`` keeps
the reference's ``log(w + 1e-10)`` stabilizer (``kernel_density.py:125``)
and the ``max(sq, 0)`` guard of the matmul-decomposed distance.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.resampling import blocked_searchsorted_take
from ..ops.stats import weighted_std

__all__ = ["KernelDensity"]

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class KernelDensity:
    """A fitted weighted Gaussian KDE."""

    X: torch.Tensor          # (..., n, d) support points
    weights: torch.Tensor    # (..., n) normalized; masked rows 0
    bandwidth: torch.Tensor  # (..., d) per-feature bandwidth

    @property
    def dim(self) -> int:
        return self.X.shape[-1]

    @property
    def n_samples(self) -> int:
        return self.X.shape[-2]

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.X.shape[:-2])

    # ------------------------------------------------------------------ fit
    @staticmethod
    def fit(X, weights=None, bandwidth="silverman") -> "KernelDensity":
        """Fit on ``X (..., n, d)`` with ``weights (..., n)`` (default
        uniform).  ``bandwidth``: 'silverman' -> ``(n (d+2) / 4)^(-1/(d+4))``,
        'scott' -> ``n^(-1/(d+4))``, times the weighted unbiased std; or an
        explicit scalar / per-feature value.  ``n`` counts positive weights;
        NaN and negative weights count as 0."""
        X = torch.as_tensor(X, dtype=torch.float32)
        n, d = X.shape[-2:]
        if weights is None:
            w = torch.full(X.shape[:-1], 1.0 / n, dtype=torch.float32,
                           device=X.device)
        else:
            w = torch.as_tensor(weights, dtype=torch.float32,
                                device=X.device)
            w = torch.where(torch.isnan(w) | (w < 0), torch.zeros_like(w), w)
            w = w / torch.sum(w, dim=-1, keepdim=True)
        if isinstance(bandwidth, str):
            n_eff = torch.sum(w > 0, dim=-1).to(torch.float32)
            if bandwidth == "silverman":
                h = (n_eff * (d + 2) / 4.0) ** (-1.0 / (d + 4))
            elif bandwidth == "scott":
                h = n_eff ** (-1.0 / (d + 4))
            else:
                raise ValueError(
                    "bandwidth should be 'silverman', 'scott' or a float")
            bw = h[..., None] * weighted_std(X, w, unbiased=True, dim=-2)
        else:
            bw = torch.as_tensor(bandwidth, dtype=torch.float32,
                                 device=X.device)
            bw = bw.expand(*X.shape[:-2], d).clone()
        return KernelDensity(X=X, weights=w, bandwidth=bw)

    # ------------------------------------------------------------- log_prob
    def log_prob(self, x, support_chunk: int = 0) -> torch.Tensor:
        """Log-density at ``x`` -> ``x.shape[:-1]``.  A batched KDE takes
        ``x (*batch_shape, N, d)``; an unbatched one any leading axes, and a
        1-D ``x`` as one point.

        The squared distance is ``|x'|^2 - 2 x'.X' + |X'|^2`` with
        ``x' = x / h``, so the cross term is a matmul and the peak
        intermediate is ``(N, n)``.  ``support_chunk > 0`` streams the
        support in chunks with a running (max, scaled-sum) logsumexp; the
        result differs from the unchunked one only by reduction order."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.X.device)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None]
        batch = self.batch_shape
        lead = x.shape[:-1]
        if batch:
            xs = (x / self.bandwidth[..., None, :]).reshape(
                *batch, -1, self.dim)                                # (.., p, d)
            Xs = self.X / self.bandwidth[..., None, :]
        else:
            xs = (x / self.bandwidth).reshape(-1, self.dim)
            Xs = self.X / self.bandwidth
        log_const = (-0.5 * self.dim * _LOG_2PI
                     - torch.sum(torch.log(self.bandwidth), dim=-1))
        if batch:
            log_const = log_const[..., None, None]
        xs_sq = torch.sum(xs * xs, dim=-1)[..., None]                # (.., p, 1)

        def weighted_kernel(Xs_c, w_c):
            """log(K(x, X_c) * (w_c + 1e-10)), (..., p, nc), in place."""
            lw = torch.matmul(xs, Xs_c.transpose(-1, -2))
            lw.mul_(-2.0).add_(xs_sq)
            lw.add_(torch.sum(Xs_c * Xs_c, dim=-1)[..., None, :])
            lw.clamp_(min=0.0)   # guard cancellation at tiny distances
            lw.mul_(-0.5).add_(log_const)
            return lw.add_(torch.log(w_c + 1e-10)[..., None, :])

        n = self.n_samples
        if not (support_chunk and support_chunk < n):
            out = torch.logsumexp(weighted_kernel(Xs, self.weights), dim=-1)
        else:
            m = s = None
            for c0 in range(0, n, int(support_chunk)):
                lw = weighted_kernel(Xs[..., c0:c0 + support_chunk, :],
                                     self.weights[..., c0:c0 + support_chunk])
                bm = torch.amax(lw, dim=-1)
                new_m = bm if m is None else torch.maximum(m, bm)
                neg = torch.isneginf(new_m)
                safe = torch.where(neg, torch.zeros_like(new_m), new_m)
                add = torch.sum(torch.exp(lw - safe[..., None]), dim=-1)
                add = torch.where(neg, torch.zeros_like(add), add)
                if m is None:
                    s = add
                else:
                    scale = torch.where(neg, torch.zeros_like(m),
                                        torch.exp(m - safe))
                    s = s * scale + add
                m = new_m
            out = m + torch.log(s)
        out = out.reshape(lead)
        return out[0] if squeeze else out

    # --------------------------------------------------------------- sample
    def pick(self, u: torch.Tensor) -> torch.Tensor:
        """The component rows chosen by uniforms ``u (..., N)`` in [0, 1):
        inverse CDF, ``idx = clip(searchsorted(cdf, u * cdf[-1], right),
        0, n-1)``.  Zero-weight rows have flat CDF segments and are never
        picked."""
        cdf = torch.cumsum(self.weights, dim=-1)
        picked, _ = blocked_searchsorted_take(cdf, u * cdf[..., -1:], self.X)
        return picked

    def sample(self, generator: torch.Generator, num_samples: int = 1,
               batch: tuple = ()) -> torch.Tensor:
        """``(*batch_shape, *batch, num_samples, d)`` draws: a component by
        :meth:`pick`, then per-feature Gaussian noise of the bandwidth's
        scale (``kernel_density.py:130-156``).  ``batch`` draws that many
        independent sets from an unbatched (shared) KDE."""
        dev = self.X.device
        shape = (*self.batch_shape, *batch, num_samples)
        u = torch.rand(shape, generator=generator, device=dev)
        z = torch.randn((*shape, self.dim), generator=generator, device=dev)
        bw = self.bandwidth[..., None, :] if self.batch_shape else self.bandwidth
        return self.pick(u) + z * bw

    def forward(self, generator: torch.Generator, num_samples: int = 1):
        samples = self.sample(generator, num_samples)
        return samples, self.log_prob(samples)
