"""The orders of K3's phases and K6's dealt work, emulated in torch on the
CPU, held to the plain versions bit for bit; the launch rules of both.

* K3 (``csrc/pool_isir.cu``): a chunk's parallel phase folds every step's
  candidate scores from -inf with a strict > into the first index of their
  maximum, the serial phase moves iff that maximum beats the current
  state's score, and the history is gathered from the winners of the moves.
  The emulation below runs these phases chunk by chunk and must equal
  ``run_plain`` (the in-order fold from the current state) to the bit, on
  pools with -inf, NaN and +inf log-weights, NaN and -inf carried weights,
  and ties forced through the ``gumbels`` callable.
* K6 (``csrc/glmala.cu``): a warp of W chains deals its local chains'
  gradient items (rank, replicate pair) over 32 lanes, 32 a round, and
  every running sum is added by one lane over its chain's items of the
  round; the emulation's sums must equal ``kernel_sl_sums`` to the bit, at
  W in {32, 16, 8, 4} with local and global chains mixed.  The global
  move's candidates dealt over a chain's helpers, folded by the butterfly's
  first maximum, pick the in-order fold's winner.
* ``glmala_launch`` (both coin modes) and ``pool_isir_launch`` at 1,000,
  16,384, 32,768 and 2,097,152 chains on 132 SMs.
"""

import numpy as np
import pytest
import torch

from glabc_tpu_torch.ops.kernels.glmala_kernel import (
    MalaConfig, glmala_launch, kernel_sl_grad, kernel_sl_sums,
    sl_grad_from_sums)
from glabc_tpu_torch.ops.kernels.mixture_kernel import _sum_dims
from glabc_tpu_torch.ops.kernels.pool_isir_kernel import (pool_isir_launch,
                                                          run_plain)

torch.set_num_threads(1)
F32 = np.float32


# ------------------------------------------------------------------- K3
def k3_phases(pool_theta, pool_logw, theta, logw, gumbels, collect, TC):
    """K3's phases on explicit noise, chunk by chunk, as the kernel runs
    them; the arguments and results of ``run_plain``."""
    T, B, d, C = pool_theta.shape
    carry, lw_cur = theta.clone(), logw.clone()
    sel = torch.full((C,), -1.0)
    moved = torch.zeros(C)
    hist = torch.empty((T, d, C)) if collect else None
    chains = torch.arange(C)
    for t0 in range(0, T, TC):
        tn = min(TC, T - t0)
        # A: every step's first maximum, independent of the state
        M = torch.full((tn, C), -float("inf"))
        lww = torch.zeros((tn, C))
        win = torch.full((tn, C), -1, dtype=torch.long)
        g_cur = torch.empty((tn, C))
        for r in range(tn):
            g = gumbels(t0 + r)
            g_cur[r] = g[:, B]
            for j in range(B):
                score = pool_logw[t0 + r, j] + g[:, j]
                upd = score > M[r]
                M[r] = torch.where(upd, score, M[r])
                lww[r] = torch.where(upd, pool_logw[t0 + r, j], lww[r])
                win[r] = torch.where(upd, torch.full_like(win[r], j), win[r])
        # B: the moves in step order
        last = torch.full((C,), -1, dtype=torch.long)
        last_at = torch.empty((tn, C), dtype=torch.long)
        for r in range(tn):
            mv = M[r] > lw_cur + g_cur[r]
            lw_cur = torch.where(mv, lww[r], lw_cur)
            sel = torch.where(mv, ((t0 + r) * B + win[r]).float(), sel)
            moved = moved + mv.float()
            last = torch.where(mv, torch.full_like(last, r), last)
            win[r] = torch.where(mv, win[r], torch.full_like(win[r], -1))
            last_at[r] = last
        # C: the winners' thetas at the moves, then the history
        th_w = torch.zeros((tn, d, C))
        for r in range(tn):
            m = win[r] >= 0
            th_w[r][:, m] = pool_theta[t0 + r, win[r][m], :, chains[m]].T
        pick = lambda l: torch.where(
            (l >= 0)[None], th_w[l.clamp_min(0), :, chains].T, carry)
        if collect:
            for r in range(tn):
                hist[t0 + r] = pick(last_at[r])
        carry = pick(last)
    return carry, lw_cur, sel, moved, hist


def _k3_inputs(T, B, d, C, seed):
    """Integer-valued pools and Gumbels, so that scores tie often, with
    -inf, NaN and +inf log-weights and NaN and -inf carried weights."""
    rng = np.random.default_rng(seed)
    ptheta = torch.from_numpy(rng.normal(size=(T, B, d, C)).astype(F32))
    lw = rng.integers(-3, 3, size=(T, B, C)).astype(F32)
    u = rng.random((T, B, C))
    lw[u < 0.15] = -np.inf
    lw[(u >= 0.15) & (u < 0.2)] = np.nan
    lw[u > 0.995] = np.inf
    theta = torch.from_numpy(rng.normal(size=(d, C)).astype(F32))
    logw = rng.integers(-3, 3, size=C).astype(F32)
    logw[::17] = np.nan
    logw[5::23] = -np.inf
    g = torch.from_numpy(rng.integers(-2, 3, size=(T, C, B + 1)).astype(F32))
    return ptheta, torch.from_numpy(lw), theta, torch.from_numpy(logw), g


@pytest.mark.parametrize("T,TC", [(70, 32), (16, 16), (9, 4), (33, 8)])
@pytest.mark.parametrize("B,d", [(5, 2), (7, 3), (1, 1)])
@pytest.mark.parametrize("collect", [True, False])
def test_k3_phases_bitwise_plain(T, TC, B, d, collect):
    ptheta, plogw, theta, logw, g = _k3_inputs(T, B, d, 100, T + B + d)
    gumbels = lambda t: g[t]
    want = run_plain(ptheta, plogw, theta, logw, gumbels, collect)
    got = k3_phases(ptheta, plogw, theta, logw, gumbels, collect, TC)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert torch.equal(torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0))
        assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert 0 < float(want[3].sum()) < T * 100         # moves and stays


def test_k3_ties_take_the_first_candidate():
    """A tie between candidates keeps the earlier one; a tie with the
    current state does not move."""
    T, B, d, C = 1, 4, 1, 3
    ptheta = torch.arange(T * B * d * C, dtype=torch.float32).reshape(
        T, B, d, C)
    plogw = torch.zeros((T, B, C))
    g = torch.tensor([[[0., 1., 1., 0., 0.],      # 1 and 2 tie: 1
                       [0., 0., 0., 0., 0.],      # all tie the state: stay
                       [2., 1., 2., 0., 0.]]])    # 0 and 2 tie: 0
    theta, logw = torch.zeros((d, C)), torch.zeros(C)
    for fn in (lambda *a: run_plain(*a, True),
               lambda *a: k3_phases(*a, True, 32)):
        out = fn(ptheta, plogw, theta, logw, lambda t: g[t])
        assert out[2].tolist() == [1.0, -1.0, 0.0]


# ------------------------------------------------------------------- K6
def _cfg(d, n_grad):
    return MalaConfig.create(
        d, np.full(d, 1.5, F32), epsilon=0.05, sigma=0.05,
        global_frequency=0.8, batch_size=5, tau=0.3, num_grad=n_grad,
        fd_step=0.1, prior_loc=0.0, prior_scale=1.0, ip_loc=0.0,
        ip_scale=1.0)


def _replicate_dis(theta, zg, cfg):
    """Each replicate's discrepancies, ``(C, n_grad, 2d)``: sign-major
    (+fd, then -fd), coordinate k; the kernel's per-item values."""
    m = cfg.mix
    C, d = theta.shape
    y_obs = torch.tensor(m.y_obs, dtype=torch.float32)
    step = cfg.fd * torch.eye(d, dtype=torch.float32)
    a_p = (theta[:, None, :] + step).abs()
    a_m = (theta[:, None, :] - step).abs()
    dis = lambda diff: torch.sqrt(_sum_dims(diff * diff))
    out = []
    for r in range(cfg.n_grad):
        zr = (m.sigma * zg[:, r])[:, None, :]
        out.append(torch.cat([dis((a_p + zr) - y_obs),
                              dis((a_m + zr) - y_obs)], dim=1))
    return torch.stack(out, dim=1).numpy()


def _ordered_sq_sum(v):
    """sum of v[r]^2 over r in order, in float32, as s2 = s2 + v * v."""
    s = np.zeros(v.shape[1], F32)
    for r in range(v.shape[0]):
        s = (s + (v[r] * v[r]).astype(F32)).astype(F32)
    return s


def dealt_sums(dis, local, N):
    """One warp's running sums as K6 adds them: ``dis (W, N, 2d)`` of its W
    chains, ``local`` the chains of the ballot.  Item i = p n + q (rank q,
    replicate pair p) of the n local chains, 32 a round, lane i % 32's;
    sum sg = rank * 2d + s is lane sg % 32's, slot sg // 32, and adds the
    round's items of its rank from pair p0 + (rank < r0) on, where the
    round starts at i0 = p0 n + r0.  The kernel steps (q, p) and (p0, r0)
    by 32 without dividing; so does this.  Where all 32 lanes own a local
    chain (W = 32, the kernel of one thread a chain), each adds its own
    items in order.  Returns ``{chain:
    (s1 (2d,), s2 (2d,))}``."""
    owners = [q for q in range(len(local)) if local[q]]
    n, two_d = len(owners), dis.shape[2]
    if n == 0:                  # the kernel skips the gradient
        return {}
    whole = N // 2
    if n == 32:                 # each lane its own items, in order
        return {o: (np.cumsum(dis[o], 0, dtype=F32)[-1],
                    _ordered_sq_sum(dis[o])) for o in owners}
    n_items, n_sums = n * ((N + 1) // 2), n * two_d
    s1 = np.zeros((32, two_d), F32)
    s2 = np.zeros((32, two_d), F32)
    q = [lane % n for lane in range(32)]
    p = [lane // n for lane in range(32)]
    p0 = r0 = 0
    dq, dp = 32 % n, 32 // n
    for i0 in range(0, n_items, 32):
        stage = {}
        for lane in range(32):
            if i0 + lane < n_items:
                assert i0 + lane == p[lane] * n + q[lane]
                reps = [2 * p[lane]] + ([2 * p[lane] + 1]
                                        if p[lane] < whole else [])
                stage[lane] = [dis[owners[q[lane]], r] for r in reps]
        assert i0 == p0 * n + r0
        i_end = min(i0 + 32, n_items)
        for lane in range(32):
            for m in range(two_d):
                sg = lane + 32 * m
                if sg >= n_sums:
                    continue
                qs, s = sg // two_d, sg % two_d
                pj = p0 + (1 if qs < r0 else 0)
                j = pj * n + qs
                while j < i_end:
                    va = stage[j - i0][0][s]
                    s1[lane, m] = F32(s1[lane, m] + va)
                    s2[lane, m] = F32(s2[lane, m] + F32(va * va))
                    if pj < whole:
                        vb = stage[j - i0][1][s]
                        s1[lane, m] = F32(s1[lane, m] + vb)
                        s2[lane, m] = F32(s2[lane, m] + F32(vb * vb))
                    j, pj = j + n, pj + 1
        for lane in range(32):
            q[lane] += dq
            p[lane] += dp
            if q[lane] >= n:
                q[lane] -= n
                p[lane] += 1
        r0, p0 = r0 + dq, p0 + dp
        if r0 >= n:
            r0, p0 = r0 - n, p0 + 1
    sums = {}
    for q_, owner in enumerate(owners):
        idx = [q_ * two_d + s for s in range(two_d)]
        sums[owner] = (np.array([s1[g % 32, g // 32] for g in idx]),
                       np.array([s2[g % 32, g // 32] for g in idx]))
    return sums


@pytest.mark.parametrize("W", [32, 16, 8, 4])
@pytest.mark.parametrize("d,N", [(2, 100), (1, 7), (4, 11), (8, 6)])
def test_k6_dealt_sums_bitwise_plain(W, d, N):
    """Warps of W chains at a per-chain coin's mix of local and global
    chains (and one warp all local, one all global), 3 warps."""
    cfg = _cfg(d, N)
    rng = np.random.default_rng(W * 100 + d * 10 + N)
    C = 3 * W
    theta = torch.from_numpy((rng.normal(size=(C, d)) * 1.3).astype(F32))
    zg = torch.from_numpy(rng.normal(size=(C, N, d)).astype(F32))
    local = rng.random(C) < 0.3
    local[:W] = True                      # the shared coin's local step
    local[W:2 * W] = False                # and its global step
    local[2 * W + 1] = True
    s1p, s2p, s1m, s2m = (x.numpy() for x in kernel_sl_sums(theta, zg, cfg))
    dis = _replicate_dis(theta, zg, cfg)
    got = {}
    for w in range(3):
        rows = slice(w * W, (w + 1) * W)
        for q, v in dealt_sums(dis[rows], local[rows], N).items():
            got[w * W + q] = v
    assert sorted(got) == list(np.flatnonzero(local))
    for c, (a1, a2) in got.items():
        assert np.array_equal(a1, np.concatenate([s1p[c], s1m[c]]))
        assert np.array_equal(a2, np.concatenate([s2p[c], s2m[c]]))
    c = np.flatnonzero(local)
    sums = [torch.from_numpy(np.stack([got[i][k][sl] for i in c]))
            for k, sl in ((0, slice(0, d)), (1, slice(0, d)),
                          (0, slice(d, 2 * d)), (1, slice(d, 2 * d)))]
    assert torch.equal(sl_grad_from_sums(theta[c], *sums, cfg),
                       kernel_sl_grad(theta[c], zg[c], cfg))


@pytest.mark.parametrize("W", [32, 16, 8, 4])
@pytest.mark.parametrize("B", [1, 5, 7])
def test_k6_candidates_dealt_over_helpers(W, B):
    """Candidate b on helper b % (32 / W), each helper's first best from
    -inf, the xor butterfly's larger score (lower candidate on ties), and
    the move iff it beats the current score: the in-order strict-> fold
    from the current state, on integer scores with many ties, -inf and
    NaN."""
    G = 32 // W
    rng = np.random.default_rng(W + B)
    for _ in range(200):
        scores = rng.integers(-2, 3, size=B).astype(F32)
        scores[rng.random(B) < 0.1] = -np.inf
        scores[rng.random(B) < 0.1] = np.nan
        cur = F32(rng.integers(-2, 3)) if rng.random() > 0.1 else F32(np.nan)
        best, want = cur, -1                  # the kernel before, in order
        for b in range(B):
            if scores[b] > best:
                best, want = scores[b], b
        helper = [(-np.inf, B)] * G
        for h in range(G):
            for b in range(h, B, G):
                if scores[b] > helper[h][0]:
                    helper[h] = (scores[b], b)
        off = 1                               # lanes W apart: helpers 1 apart
        while off < G:
            helper = [min(helper[h], helper[h ^ off],
                          key=lambda v: (-v[0], v[1])) for h in range(G)]
            off <<= 1
        assert len(set(helper)) == 1
        m, jb = helper[0]
        got = jb if m > cur else -1
        assert got == want


# ---------------------------------------------------------- launch rules
@pytest.mark.parametrize("mode,C,want", [
    ("per_chain", 1000, (32, 4)), ("per_chain", 16384, (256, 8)),
    ("per_chain", 32768, (256, 16)), ("per_chain", 2097152, (256, 16)),
    ("shared", 1000, (32, 4)), ("shared", 16384, (128, 16)),
    ("shared", 32768, (128, 32)), ("shared", 2097152, (256, 32))])
def test_glmala_launch(mode, C, want):
    threads, lanes = glmala_launch(C, 132, mode)
    assert (threads, lanes) == want
    warps = -(-C // lanes)
    assert warps >= (4 if mode == "shared" else 8) * 132 or lanes == 4
    assert -(-warps * 32 // threads) >= 132 or threads == 32


@pytest.mark.parametrize("C,want", [(1000, 1024), (16384, 512),
                                    (32768, 256), (2097152, 256)])
def test_pool_isir_launch(C, want):
    assert pool_isir_launch(C, 132) == want


# ------------------------------------------------- chip_smoke.py's counts
def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k3_recount_on_synthetic_input():
    """K3's bytes count the B log-weights, the winner's d floats on each
    chain-step that moves, the history and the state; its operations a
    hand count per chain-step plus d per move.  The count before read
    every candidate's theta."""
    cs = _chip_smoke()
    T, B, d, C = 4, 5, 2, 8
    a = (0, torch.zeros((T, B, d, C)), torch.zeros((T, B, C)),
         torch.zeros((d, C)), torch.zeros(C))
    moved = torch.tensor([0., 1., 2., 0., 4., 0., 0., 3.])    # 10 moves
    outs = (torch.zeros((d, C)), torch.zeros(C), torch.zeros(C), moved,
            torch.zeros((T, d, C)))
    b, b_old, by, ops, by_old, ops_old = cs.pool_isir_bound(a, outs)
    state = 4 * (d * C + C) + 4 * (d * C + 3 * C)
    assert by == 4 * T * B * C + 4 * T * d * C + state + 4 * d * 10
    assert by_old == 4 * T * B * C + 4 * T * B * d * C + 4 * T * d * C + state
    per_step = 2 * 80 + 9 * (B + 1) + 5 * B + 5      # 244
    assert cs.pool_isir_ops(d, B) == (per_step, d)
    assert ops == per_step * C * T + d * 10
    assert ops_old == (2 * 80 + 9 * (B + 1) + B * (d + 5)) * C * T
    # without the history
    b2 = cs.pool_isir_bound(a, outs[:4] + (None,))
    assert b2[2] == by - 4 * T * d * C
    assert b[0] < b_old[0]


def test_k6_bound_counts_each_coin():
    """K6's bound counts the move each chain-step's coin picked (the
    ``gatt`` counter), and the shared coins' bytes only in shared mode."""
    cs = _chip_smoke()
    C, T, d = 64, 8, 2

    class K:
        pass

    for mode in ("shared", "per_chain"):
        kern = K()
        kern.T, kern.d, kern.B, kern.coin_mode = T, d, 5, mode
        kern.cfg = _cfg(d, 100)
        coins = torch.zeros(T, dtype=torch.int32) if mode == "shared" \
            else None
        state = [torch.zeros((d, C)), torch.zeros((d, C)), torch.zeros(C),
                 torch.zeros((d, C))]
        gatt = torch.full((C,), 6.0)
        outs = [*state, torch.zeros((T, d, C)), torch.zeros(C), gatt,
                torch.zeros(C), torch.zeros(C)]
        b, moved, ops, sfu, n_local = cs.glmala_bound(
            kern, (0, *state, coins), outs)
        ol, sl = cs.glmala_ops(d, 5, 100, True)
        og, sg = cs.glmala_ops(d, 5, 100, False)
        assert n_local == 2 * C
        assert ops == 2 * C * ol + 6 * C * og and sfu == 2 * C * sl + 6 * C * sg
        want = 4 * (3 * d * C + C) * 2 + 4 * T * d * C + 16 * C
        assert moved == want + (4 * T if mode == "shared" else 0)
