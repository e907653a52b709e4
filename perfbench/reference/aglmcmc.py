"""AGLMCMC's shared adaptation epoch and its mixed transition, in plain
torch (reference ``AGLMCMC.py:130-249`` of caofff/GL-ABC-MCMC, with one
quantile and one KDE shared by all chains).

The epoch, from the pools ``(theta, x, dis, log_q)`` of every chain:

* anneal: ``q = clamp(alpha #{dis < eps} / n, 0, 1)``, ``eps' =
  max(quantile(dis, q), eps_T)`` (linear interpolation at ``q (n - 1)``);
  an ``eps`` at ``eps_T`` stays;
* support: ``N`` rows resampled systematically from all rows by the weights
  ``prior(theta) N(dis; 0, eps'^2) / q(theta)``: row ``i`` appears
  ``floor(N w_i)`` or ``ceil(N w_i)`` times;
* KDE: uniform weights on the support, Silverman bandwidth
  ``(N (d + 2) / 4)^(-1 / (d + 4))`` times the unbiased standard deviation;
  ``log q(x) = logsumexp_i(log(1/N + 1e-10) + log N(x; X_i, diag h^2))``;
* new pools drawn from the KDE, each row weighted ``prior + log K(dis) -
  log q``.

The transition (``global_frequency < 1``): a coin; global is iSIR over the
step's slice of ``B`` pool rows, with the current state weighted under the
epoch's KDE; local is the Mixture random-walk MH move.  Its random numbers
are the port's: Philox blocks ``(chain, step, 0..)``, ``ceil((B + 3) / 4)``
blocks of scalars (Gumbels of the ``B`` rows and of the current state, the
local uniform, the coin), then one block per two dims of Box-Muller pairs.
"""

from __future__ import annotations

import math

import torch

from .mixture import (LOG_2PI, Problem, f32, gauss_lp, kern_lp,
                      kernel_log_prob, prior_log_prob, sum_dims)
from .philox import gumbel, normal_pair, uniforms

_LANES = 32


# ------------------------------------------------------------------- epoch
def anneal(dis: torch.Tensor, eps_in: float, alpha: float, eps_T: float,
           dtype=torch.float64) -> float:
    """The annealed threshold from every chain's pool discrepancies
    ``dis`` (float32, any shape).  The count compares in float32, as the
    thresholds are float32; the order statistics are interpolated in
    ``dtype``."""
    if not f32(eps_in) > f32(eps_T):
        return float(eps_in)
    d = dis.reshape(-1)
    n = d.shape[0]
    num_a = int(torch.sum(d < f32(eps_in)))
    q = min(max(alpha * num_a / n, 0.0), 1.0)
    xs = torch.sort(d.to(dtype) if dtype == torch.bfloat16 else d).values
    pos = q * (n - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    lo_v = xs[min(max(lo, 0), n - 1)].to(dtype)
    hi_v = xs[min(max(hi, 0), n - 1)].to(dtype)
    hw = torch.tensor(pos - lo, dtype=dtype, device=d.device)
    v = lo_v * (1.0 - hw) + hi_v * hw
    return max(float(v), float(eps_T))


def training_weights(theta, dis, log_q, eps: float, dtype=torch.float64):
    """Normalised weights ``prior N(dis; 0, eps^2) / q`` of every row
    (NaN as 0), in ``dtype``."""
    th = theta.reshape(-1, theta.shape[-1]).to(dtype)
    lw = (prior_log_prob(th) + kernel_log_prob(dis.reshape(-1).to(dtype), eps)
          - log_q.reshape(-1).to(dtype))
    w = torch.exp(lw)
    w = torch.where(torch.isnan(w), torch.zeros_like(w), w)
    return w / torch.sum(w)


def systematic(w: torch.Tensor, num: int, u0: float) -> torch.Tensor:
    """Systematic resampling of ``num`` indices at offset ``u0``."""
    c = torch.cumsum(w, dim=0)
    u = (u0 + torch.arange(num, dtype=w.dtype, device=w.device)) / num
    return torch.clamp(torch.searchsorted(c, u * c[-1], right=True), 0,
                       w.shape[0] - 1)


def _keys(theta: torch.Tensor) -> torch.Tensor:
    """One int64 key per float32 row of two coordinates (their bits)."""
    b = theta.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return (b[:, 0] << 32) | (b[:, 1] & 0xFFFFFFFF)


def support_bad_share(theta, w, X, delta: float = 1e-3) -> float:
    """How far ``X (N, 2)`` is from a systematic resample of the rows
    ``theta (n, 2)`` by the normalised weights ``w (n,)``: the support rows
    that are no pool row, plus every count outside ``[floor(N w_i -
    delta), ceil(N w_i + delta)]`` by how far it lies outside, over ``N``.
    0 for a sound resample."""
    N = X.shape[0]
    keys = _keys(theta.reshape(-1, theta.shape[-1]))
    skeys, order = torch.sort(keys)
    xk = _keys(X)
    pos = torch.clamp(torch.searchsorted(skeys, xk), max=skeys.shape[0] - 1)
    found = skeys[pos] == xk
    counts = torch.zeros(keys.shape[0], dtype=torch.float64, device=w.device)
    counts.index_add_(0, order[pos[found]],
                      torch.ones(int(found.sum()), dtype=torch.float64,
                                 device=w.device))
    E = N * w.to(torch.float64)
    lo = torch.clamp_min(torch.floor(E - delta), 0.0)
    hi = torch.ceil(E + delta)
    off = (torch.clamp_min(counts - hi, 0.0).sum()
           + torch.clamp_min(lo - counts, 0.0).sum())
    return float((int((~found).sum()) + float(off)) / N)


def silverman(X: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Silverman bandwidth of uniform weights on ``X (N, d)``."""
    X = X.to(dtype)
    N, d = X.shape
    w = torch.full((N,), 1.0 / N, dtype=dtype, device=X.device)
    mean = torch.sum(w[:, None] * X, dim=0)
    var = torch.sum(w[:, None] * (X - mean) ** 2, dim=0)
    var = var / (1.0 - torch.sum(w * w))
    h = (N * (d + 2) / 4.0) ** (-1.0 / (d + 4))
    return h * torch.sqrt(var)


def kde_log_q(x, X, h, dtype=torch.float64, chunk: int = 8192):
    """``log q`` of rows ``x (R, d)`` under the uniform KDE ``(X, h)``."""
    X, h = X.to(dtype), h.to(dtype)
    d = X.shape[1]
    lw = math.log(1.0 / X.shape[0] + 1e-10)
    const = -0.5 * d * LOG_2PI - torch.sum(torch.log(h))
    out = []
    for r0 in range(0, x.shape[0], chunk):
        z = (x[r0:r0 + chunk, None, :].to(dtype) - X[None]) / h
        out.append(torch.logsumexp(lw - 0.5 * torch.sum(z * z, dim=-1),
                                   dim=-1) + const)
    return torch.cat(out)


def pool_rows(pb: Problem, theta, x, X, h, dtype=torch.float64):
    """``(dis, log q, log w)`` of pool rows drawn from the KDE ``(X, h)``:
    the discrepancy of their datasets, their density and their weight at
    the problem's epsilon."""
    th, xx = theta.to(dtype), x.to(dtype)
    diff = xx - torch.tensor(pb.y_obs, dtype=dtype, device=xx.device)
    dis = torch.sqrt(torch.sum(diff * diff, dim=-1))
    log_q = kde_log_q(th, X, h, dtype)
    log_w = (prior_log_prob(th) + kernel_log_prob(dis, pb.epsilon)) - log_q
    return dis, log_q, log_w


def widest_gap(got, want) -> float:
    """``max |got - want| / max(1, |want|)`` (infinite where one side is
    not finite and the other is, or they differ in sign of infinity)."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    both = ~torch.isfinite(want) & (got == want)
    g = (got - want).abs() / torch.clamp_min(want.abs(), 1.0)
    g = torch.where(both, torch.zeros_like(g), g)
    g = torch.where(torch.isnan(g), torch.full_like(g, math.inf), g)
    return float(g.max()) if g.numel() else 0.0


# -------------------------------------------------------------- transition
def resident_log_q(X, h, theta):
    """``log q`` of states ``theta (R, d)`` under the uniform KDE ``(X,
    h)``, written as a warp of 32 lanes sums it in float32: ``log q =
    logsumexp_i(pre_i + (X_i / h^2) . theta) - 0.5 sum_k theta_k^2 / h_k^2``
    with ``pre_i = log(1/N + 1e-10) - 0.5 sum_k X_ik^2 / h_k^2 - sum_k log
    h_k - (d/2) log 2 pi``; component ``i`` on lane ``i % 32``, the lanes'
    sums joined by an xor butterfly."""
    dt = theta.dtype
    X = X.to(dt)
    h = h.to(dt)
    N, d = X.shape
    inv_h2 = 1.0 / (h * h)
    const = -torch.sum(torch.log(h)) - 0.5 * d * LOG_2PI
    log_w = torch.log(torch.full((N,), 1.0 / N, dtype=dt,
                                 device=X.device) + 1e-10)
    pre = log_w + const - 0.5 * torch.sum(X * X * inv_h2, dim=-1)
    mu = X * inv_h2
    dot = None
    for f in range(d):
        p = mu[None, :, f] * theta[:, f:f + 1]
        dot = p if dot is None else dot + p
    sc = dot + pre[None, :]
    m = torch.clamp_min(torch.amax(sc, dim=-1), -1.0e30)
    e = torch.exp(sc - m[:, None])
    R = e.shape[0]
    pad = -N % _LANES
    if pad:
        e = torch.cat([e, e.new_zeros((R, pad))], dim=1)
    e = e.reshape(R, -1, _LANES)
    s = e[:, 0]
    for k in range(1, e.shape[1]):
        s = s + e[:, k]
    idx = torch.arange(_LANES, device=s.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, idx ^ off]
    q2 = sum_dims((theta * theta) * inv_h2)
    return (torch.log(s[:, 0]) + m) - 0.5 * q2


def mixed_replay(pb: Problem, B: int, gf: float, lp_scale: float, seed: int,
                 chain, step0: int, state, pool, X, h, dtype=torch.float32):
    """``T`` transitions of rows ``chain (R,)`` (global chain indices) from
    absolute step ``step0``: ``state = (theta (R, d), y (R, d), logk
    (R,))``, ``pool = (theta (R, T B, d), x (R, T B, d), log_w (R, T B),
    dis (R, T B))``, slice ``t`` being rows ``t B .. t B + B - 1``; the
    current state weighted under the KDE ``(X, h)``.  Returns the final
    state and the int64 counters ``(global attempts, global accepts, local
    accepts)``, computed in ``dtype``."""
    theta, y, logk = (s.to(dtype) for s in state)
    ptheta, px, plogw, pdis = pool
    R, P, d = ptheta.shape
    T = P // B
    plogk = kernel_log_prob(pdis.to(torch.float32), pb.epsilon).to(dtype)
    ptheta, px, plogw = ptheta.to(dtype), px.to(dtype), plogw.to(dtype)
    gf, lp_scale = f32(gf), f32(lp_scale)
    sb = -(-(B + 3) // 4)
    counts = [torch.zeros(R, dtype=torch.int64, device=chain.device)
              for _ in range(3)]
    for t in range(T):
        u = uniforms(seed, chain, step0 + t, sb + -(-d // 2))
        pairs = u[:, 4 * sb:4 * sb + 2 * d].reshape(R, d, 2).to(dtype)
        l1, l2 = normal_pair(pairs[..., 0], pairs[..., 1])
        sc = u[:, :B + 3].to(dtype)
        g = gumbel(sc[:, :B + 1])
        lp_theta = gauss_lp(theta, 0.0, 1.0, pb.c_prior)
        best = ((lp_theta + logk) - resident_log_q(X, h, theta)) + g[:, B]
        b_th, b_y, b_lk = theta, y, logk
        moved = torch.zeros(R, dtype=torch.bool, device=chain.device)
        for j in range(B):
            r = t * B + j
            score = plogw[:, r] + g[:, j]
            upd = score > best
            best = torch.where(upd, score, best)
            b_th = torch.where(upd[:, None], ptheta[:, r], b_th)
            b_y = torch.where(upd[:, None], px[:, r], b_y)
            b_lk = torch.where(upd, plogk[:, r], b_lk)
            moved = moved | upd
        thl = theta + lp_scale * l1
        yl = thl.abs() + pb.sigma * l2
        lkl = kern_lp(pb, yl)
        l_acc = torch.log(sc[:, B + 1]) < (
            (gauss_lp(thl, 0.0, 1.0, pb.c_prior) + lkl) - lp_theta) - logk
        is_g = sc[:, B + 2] < gf
        theta = torch.where(is_g[:, None], b_th,
                            torch.where(l_acc[:, None], thl, theta))
        y = torch.where(is_g[:, None], b_y,
                        torch.where(l_acc[:, None], yl, y))
        logk = torch.where(is_g, b_lk, torch.where(l_acc, lkl, logk))
        for c, inc in zip(counts, (is_g, is_g & moved, ~is_g & l_acc)):
            c += inc.to(torch.int64)
    return (theta.to(torch.float32), y.to(torch.float32),
            logk.to(torch.float32)), counts
