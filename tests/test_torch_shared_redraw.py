"""The shared AGLMCMC epoch's redraw through K10 and K4's pool epilogue, on
the CPU.

For a problem of the ``|theta| + sigma N(0, I)`` family the shared epoch
draws each chunk's ``u``, ``z`` and simulator noise up front and hands them
to K10 (``ops/kernels/shared_redraw_kernel.py``; its plain version for CPU
tensors), then K4 takes the density and writes the log-weights.  Held here:

* the new chunk path against the sequence it replaces (``_redraw``, K4,
  ``_pool_from_proposals`` a chunk) on the same generator: theta and x
  bitwise, dis, log q and log w within 1e-6 max(1, |v|), the generator
  left in the same state; at the cell's shape scaled down, with a KDE
  whose draws mostly fall outside the prior's cutoff (the fill rule), with
  a NaN bandwidth (the NaN-row rules), at ``redraw_chunk`` 0 and a
  divisor, and at d = 3 and 40 (K10's runtime-d kernel);
* an emulation of the kernel's walk (a block's tiles, the ballot counts,
  the stop at P valid rows, the fill pass) at 256 and 8 threads a block,
  bitwise the plain version;
* ``chip_smoke.redraw_bytes``, K10's bound on the card, against a hand
  count.  (Which problems keep the generic path, and the redraw span's
  bytes on each path: ``test_torch_tracing.py``.)
"""

import math

import pytest
import torch

from glabc_tpu_torch import (DiagGaussian, HighDimMixtureProblem,
                             MixtureProblem)
from glabc_tpu_torch.models.kde import KernelDensity
from glabc_tpu_torch.ops.kernels.shared_redraw_kernel import SharedRedraw
from glabc_tpu_torch.samplers import aglmcmc as agl

C, P, SUPPORT = 8, 30, 64
CFG = agl.AGLMCMCConfig(0.5, 5, 6, 0.8, 0.2, 4, 0, 0)


def _problem(d):
    return MixtureProblem(0.05) if d == 2 else HighDimMixtureProblem(d)


def _kde(kind, d):
    """A shared KDE: fitted on a drawn pool, or placed far out (about a
    sixth of its draws inside the prior's cutoff), or with a NaN
    bandwidth."""
    g = torch.Generator().manual_seed(d)
    if kind == "fitted":
        ip = DiagGaussian.create(d, 0.0, 0.0)
        pools = agl._init_pools(_problem(d), g, ip, C, P)
        return KernelDensity.fit(pools.theta.reshape(-1, d)[:SUPPORT])
    X = torch.randn((16, d), generator=g)
    bw = torch.full((d,), 0.2)
    if kind == "far":
        X = torch.zeros((2, d))
        X[0, 0] = X[1, -1] = 6.8
        bw = torch.full((d,), 0.3)
    else:
        bw[0] = math.nan
    n = X.shape[0]
    return KernelDensity(X, torch.full((n,), 1.0 / n), bw)


def _replaced(problem, kde, chunk, seed):
    """The sequence K10 replaces, a chunk at a time: ``_redraw``, K4 over
    the draws, ``_pool_from_proposals``; and the generator after it."""
    g = torch.Generator().manual_seed(seed)
    density = agl._shared_density(kde)
    parts = []
    for _ in range(0, C, chunk):
        theta = agl._redraw(problem, CFG, g, kde, P, batch=(chunk,))
        parts.append(agl._pool_from_proposals(problem, g, theta,
                                              density(theta)))
    return agl.Pool.cat(parts), g


def _assert_same_pools(new, old):
    assert torch.equal(new.theta, old.theta)
    assert torch.equal(new.x, old.x)
    for a, b in ((new.dis, old.dis), (new.log_q, old.log_q),
                 (new.log_w, old.log_w)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.isinf(a), torch.isinf(b))
        fin = torch.isfinite(b)
        assert torch.equal(a[~fin].nan_to_num(), b[~fin].nan_to_num())
        if fin.any():
            err = (a[fin] - b[fin]).abs() / b[fin].abs().clamp_min(1.0)
            assert float(err.max()) <= 1e-6


@pytest.fixture
def k10_calls(monkeypatch):
    """The shapes of ``u`` of every K10 call (``run``), in order."""
    calls = []
    orig = SharedRedraw.run

    def run(self, u, *args, **kw):
        calls.append(tuple(u.shape))
        return orig(self, u, *args, **kw)

    monkeypatch.setattr(SharedRedraw, "run", run)
    return calls


@pytest.mark.parametrize("kind,d,redraw_chunk", [
    ("fitted", 2, 2), ("fitted", 2, 0), ("far", 2, 4), ("nan_bw", 2, 2),
    ("fitted", 3, 4), ("far", 40, 2)])
def test_chunk_path_matches_the_replaced_sequence(kind, d, redraw_chunk,
                                                  k10_calls):
    problem, kde = _problem(d), _kde(kind, d)
    chunk = redraw_chunk or C
    g = torch.Generator().manual_seed(11)
    new = agl._redraw_chunks(problem, CFG, g, kde, C, P, chunk)
    old, g_old = _replaced(problem, kde, chunk, 11)
    assert k10_calls == [(chunk, CFG.oversample * P)] * (C // chunk)
    _assert_same_pools(new, old)
    assert torch.equal(g.get_state(), g_old.get_state())
    valid = problem.prior_log_prob(new.theta) > agl._PRIOR_CUTOFF
    if kind == "far":           # the fill rule engaged (at d = 40 every
        # candidate is out: N(0, I_40)'s density is below 1e-10 at 0)
        assert float(valid.float().mean()) < 1
        assert (float(valid.float().mean()) > 0) == (d == 2)
    if kind == "nan_bw":        # every row NaN as drawn: zeroed, -inf
        assert torch.equal(new.theta, torch.zeros_like(new.theta))
        assert bool(torch.isneginf(new.log_w).all())
        assert bool((new.dis == agl._NAN_DIS).all())


def _walk(u, z, noise, inputs, threads):
    """K10's walk (``csrc/shared_redraw.cu``) in torch, chain by chain: the
    block's tiles of ``threads`` candidates, the valid count before each
    from its warp's ballot and the counts of the warps before it, the stop
    once P valid rows are placed, the second walk for the invalid ones,
    the rows' arithmetic in the kernel's order."""
    (Cc, M), (Pp, d) = u.shape, noise.shape[1:]
    cdf, X, bw, y_obs, logk0 = inputs[:5]
    n = cdf.shape[0]
    out = [torch.full(s, math.nan) for s in ((Cc, Pp, d), (Cc, Pp, d),
                                              (Cc, Pp), (Cc, Pp))]

    def cand(c, i, k):
        return X[k] + z[c, i] * bw

    def prior(c, i, k):
        s = torch.zeros(())
        for f in range(d):
            v = cand(c, i, k)[f]
            s = s + v * v
        return torch.tensor(inputs.prior0) - 0.5 * s

    def pick(q):
        lo, hi = 0, n
        while lo < hi:
            mid = lo + ((hi - lo) >> 1)
            if not bool(cdf[mid] > q):
                lo = mid + 1
            else:
                hi = mid
        return min(lo, n - 1)

    def write(c, i, k, pr, s):
        v = cand(c, i, k)
        nan_row = bool(torch.isnan(v).any())
        out[0][c, s] = v
        safe = torch.zeros_like(v) if nan_row else v
        x = torch.abs(safe) + torch.tensor(inputs.sigma) * noise[c, s]
        out[1][c, s] = x
        ss = torch.zeros(())
        for f in range(d):
            diff = x[f] - y_obs[f]
            ss = ss + diff * diff
        dis = torch.sqrt(ss)
        if nan_row or bool(torch.isnan(dis)):
            dis = torch.tensor(inputs.nan_dis)
        r = dis / torch.tensor(inputs.epsilon)
        out[2][c, s] = dis
        out[3][c, s] = pr + (logk0 - 0.5 * (r * r))

    for c in range(Cc):
        placed = 0
        for want_valid in (True, False):
            for t0 in range(0, M, threads):
                if placed >= Pp:
                    break
                tile = []                     # (flag, i, k, prior) a thread
                for i in range(t0, t0 + threads):
                    if i >= M:
                        tile.append((False, None, None, None))
                        continue
                    k = pick(u[c, i] * cdf[-1])
                    pr = prior(c, i, k)
                    tile.append((bool(pr > inputs.cutoff) == want_valid,
                                 i, k, pr))
                before = 0                    # the counts of earlier warps
                for w0 in range(0, threads, 32):
                    ballot = [t[0] for t in tile[w0:w0 + 32]]
                    for lane, (flag, i, k, pr) in enumerate(tile[w0:w0 + 32]):
                        dest = placed + before + sum(ballot[:lane])
                        if flag and dest < Pp:
                            write(c, i, k, pr, dest)
                    before += sum(ballot)
                placed += before
            if placed >= Pp:
                break
    return tuple(out)


@pytest.mark.parametrize("kind,threads", [("fitted", 256), ("fitted", 8),
                                          ("far", 8), ("nan_bw", 8)])
def test_kernel_walk_matches_the_plain_version(kind, threads):
    d, Cc, Pp = 2, 3, 20
    problem, kde = _problem(d), _kde(kind, d)
    g = torch.Generator().manual_seed(5)
    M = CFG.oversample * Pp
    u = torch.rand((Cc, M), generator=g)
    z = torch.randn((Cc, M, d), generator=g)
    noise = torch.randn((Cc, Pp, d), generator=g)
    inputs = agl._redraw_inputs(problem, kde)
    want = SharedRedraw().plain(u, z, noise, inputs)
    got = _walk(u, z, noise, inputs, threads)
    for a, b in zip(got, want):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
        assert torch.equal(torch.isnan(a), torch.isnan(b))


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_redraw_bytes_counts_what_the_walk_reads():
    """``chip_smoke.redraw_bytes`` (K10's bound on the card) on a KDE whose
    first component is valid and second far out, so that ``u < 1/2`` marks
    the valid candidates: a hand count of the candidates each chain reads
    (up to its P-th valid one; all and then up to the filling invalid one
    when fewer are valid), 12 bytes each at d = 2, beside the noise, the
    rows written and the KDE's arrays."""
    d, Pp, M = 2, 3, 12
    kde = KernelDensity(torch.tensor([[0.0, 0.0], [9.0, 0.0]]),
                        torch.tensor([0.5, 0.5]), torch.full((d,), 1e-3))
    inputs = agl._redraw_inputs(MixtureProblem(0.05), kde)
    pattern = ["vvv" + "x" * 9, "xvxxvxxxvxxx", "vxxxxxxxxxxx",
               "xxxvxxxxxxxv"]
    u = torch.tensor([[0.25 if ch == "v" else 0.75 for ch in row]
                      for row in pattern])
    z = torch.zeros((len(pattern), M, d))
    noise = torch.zeros((len(pattern), Pp, d))
    reads = []
    for row in pattern:
        valid = [i for i, ch in enumerate(row) if ch == "v"]
        if len(valid) >= Pp:
            reads.append(valid[Pp - 1] + 1)
        else:
            bad = [i for i, ch in enumerate(row) if ch != "v"]
            reads.append(M + bad[Pp - len(valid) - 1] + 1)
    assert reads == [3, 9, 12 + 3, 12 + 1]
    want = (sum(reads) * 4 * (1 + d) + noise.numel() * 4
            + len(pattern) * Pp * (2 * d + 2) * 4 + 4 * (2 + 4 + 2 + 2))
    got = _chip_smoke().redraw_bytes(u, z, noise, inputs)
    assert got == want
    assert bool((SharedRedraw().plain(u, z, noise, inputs)[0][0, :, 0]
                 == 0).all())
