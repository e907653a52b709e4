"""Collectives of the chain-sharded samplers, on ``torch.distributed``.

Port of ``glabc_tpu/parallel/sharded.py``.  Each function works on this
rank's tensors and the mesh's process group, called by every rank alike
(there is no ``shard_map``):

* :func:`distributed_quantile` / :func:`sharded_hat_eps_update`: the
  AGLMCMC epsilon-annealing quantile (``AGLMCMC.py:174-196``) over every
  rank's pool discrepancies, by a radix select that sums digit histograms
  over the group;
* :func:`distributed_systematic_resample`: systematic resampling over a
  rank-sharded weight vector, on the global float64 CDF and one shared
  ``u0``, each rank searching its own part of the CDF from the ranks'
  weight totals;
* :func:`make_sharded_shared_epoch`: the shared adaptation epoch, every
  rank fitting the identical KDE;
* :func:`make_sharded_flow_trainer` / :func:`make_sharded_chain_state_trainer`:
  data-parallel GLMCMC-NF refits, gradients averaged over the group so every
  rank applies the identical Adam step.

Where JAX folds the device index into a key, a rank draws from
:func:`rank_generator`: one seed from the shared generator (which every rank
consumes alike) and the rank.  Those draws match a one-device run in
distribution only, as JAX's do.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.profiling import annotate
from .mesh import check_mesh, gather_chains

__all__ = ["rank_generator", "distributed_quantile",
           "distributed_systematic_resample", "sharded_hat_eps_update",
           "make_sharded_shared_epoch", "make_sharded_flow_trainer",
           "make_sharded_chain_state_trainer"]

# odd 64-bit multiplier that spreads the rank over the seed's bits
_RANK_STRIDE = 0x9E3779B97F4A7C15


def rank_generator(generator: torch.Generator, mesh) -> torch.Generator:
    """A generator of this rank's own: seeded from one draw of the shared
    ``generator`` (the same draw on every rank) and the rank."""
    rank, _, _ = check_mesh(mesh)
    base = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device))
    g = torch.Generator(device=generator.device)
    g.manual_seed((base + (rank + 1) * _RANK_STRIDE) % 2**63)
    return g


def _all_sum(x: torch.Tensor, mesh, *, inplace: bool = False
             ) -> torch.Tensor:
    """The sum of every rank's ``x``, into ``x`` itself where ``inplace``."""
    _, _, group = check_mesh(mesh)
    if not inplace:
        x = x.clone()
    with annotate("glabc.mesh.all_sum", x.numel() * x.element_size()):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def distributed_quantile(x_local: torch.Tensor, q, mesh) -> torch.Tensor:
    """Quantile ``q`` (a scalar) of the global array whose rank shard is
    ``x_local`` (equal shards), as ``jnp.quantile`` takes it: linear
    interpolation between the order statistics at ``floor`` and ``ceil`` of
    ``q (n - 1)``, float32
    (:func:`~glabc_tpu_torch.samplers.aglmcmc.quantile`).

    Exact, and no rank sees another's values: a radix select
    (:func:`~glabc_tpu_torch.ops.kernels.radix_select_kernel.
    radix_select`, K11 on the card), whose digit histograms (``2 x 2^bits``
    int64 a pass, ``len(DIGITS)`` passes) are summed over the group.  The
    result equals the quantile of the gathered array bit for bit, but that a
    zero reads as +0.0.  Only float32 shards are taken (the pools'
    discrepancies); another dtype raises ``TypeError``."""
    from ..ops.kernels.radix_select_kernel import radix_select
    from ..samplers.aglmcmc import quantile_position

    x_local = x_local.reshape(-1)
    if x_local.dtype != torch.float32:
        raise TypeError(f"distributed_quantile takes float32 shards, got "
                        f"{x_local.dtype}")
    n = x_local.shape[0] * check_mesh(mesh)[1]
    lo_i, hi_i, lw, hw = quantile_position(q, n, x_local.device)
    v = radix_select(x_local, torch.stack([lo_i, hi_i]),
                     combine=lambda h: _all_sum(h, mesh, inplace=True))
    return v[0] * lw + v[1] * hw


def _owned_indices(w: torch.Tensor, u: torch.Tensor, mesh):
    """``(owned, idx)`` of the grid ``u`` on this rank's cleaned float64
    weights ``w``: the points of ``u`` that fall in this rank's part of
    the global CDF (``P_r <= u < P_{r+1}``, ``P`` the normalized prefix of
    the ranks' totals; the first rank owns what lies below, the last what
    lies above) and, for those, the global index of the row they pick, by
    ``searchsorted`` on ``P_r + cumsum(w / S)`` clamped to the rank's last
    row.  The ranks' totals are the only exchange (one float64 each)."""
    rank, world, _ = check_mesh(mesh)
    mine = torch.zeros(world, dtype=torch.float64, device=w.device)
    mine[rank] = torch.sum(w)
    totals = _all_sum(mine, mesh, inplace=True)   # one term a slot: exact
    total = torch.sum(totals)
    ends = torch.cumsum(totals / total, dim=0)
    owner = torch.searchsorted(ends[:-1].contiguous(), u, right=True)
    start = ends[rank - 1] if rank else torch.zeros_like(total)
    c = start + torch.cumsum(w / total, dim=-1)
    idx = torch.clamp(torch.searchsorted(c, u, right=True), 0,
                      w.shape[0] - 1) + rank * w.shape[0]
    return owner == rank, idx


def distributed_systematic_resample(w_local: torch.Tensor, num: int, mesh,
                                    generator: torch.Generator, *,
                                    replicated: bool = False
                                    ) -> torch.Tensor:
    """Systematic resampling over a weight vector sharded by rank (equal
    shards).

    The global CDF is the float64 cumulative sum of the joined shards (NaNs
    and negatives count as 0), normalized; ``u0`` is one draw of the shared
    ``generator``, the same on every rank.  ``replicated=False``: the grid
    has ``num x world`` points and this rank keeps its ``num``, slots
    ``rank num ..``; joined in rank order they are
    :func:`~glabc_tpu_torch.ops.resampling.systematic_resample`'s indices
    on the global weights.  ``replicated=True``: every rank gets the whole
    grid of ``num`` points.  Indices are global (into the ranks' shards
    joined in rank order).

    No rank sees another's weights: the ranks sum their totals, each finds
    the grid points in its own part of the CDF (:func:`_owned_indices`),
    and a sum over the group of the indices, 0 where not owned, joins them.
    The indices equal the gathered CDF's but where a grid point lies within
    float64 rounding of a row's boundary."""
    rank, world, _ = check_mesh(mesh)
    w = w_local.reshape(-1).to(torch.float64)
    w = torch.where(torch.isnan(w) | (w < 0), torch.zeros_like(w), w)
    N, offset = (num, 0) if replicated else (num * world, rank * num)
    u0 = torch.rand((), generator=generator, dtype=torch.float64,
                    device=w.device)
    u = (u0 + torch.arange(N, dtype=torch.float64, device=w.device)) / N
    owned, idx = _owned_indices(w, u, mesh)
    idx = _all_sum(torch.where(owned, idx, 0), mesh, inplace=True)
    return idx[offset:offset + num]


def sharded_hat_eps_update(alpha: float, hat_eps_T: float, mesh):
    """The global epsilon-annealing rule (``AGLMCMC.py:174-196`` over every
    rank's pool): ``update(dis_local, hat_eps) -> hat_eps``, the value a
    one-device anneal over the joined pools gives."""

    def update(dis_local: torch.Tensor, hat_eps: torch.Tensor):
        dis_local = dis_local.reshape(-1)
        num_a = _all_sum(torch.sum(dis_local < hat_eps), mesh)
        n = dis_local.shape[0] * check_mesh(mesh)[1]
        q = torch.clamp(alpha * num_a / n, 0.0, 1.0)
        new = torch.clamp_min(distributed_quantile(dis_local, q, mesh),
                              hat_eps_T)
        return torch.where(hat_eps > hat_eps_T, new, hat_eps)

    return update


def make_sharded_shared_epoch(problem, cfg, shared_support: int, mesh,
                              redraw_chunk: int = 0):
    """The shared AGLMCMC adaptation epoch over chain-sharded pools
    (:func:`~glabc_tpu_torch.samplers.aglmcmc.make_shared_epoch_fn` with
    collectives in place of one device's arrays):

    * ``hat_eps`` anneals over every rank's discrepancies
      (:func:`sharded_hat_eps_update`);
    * the KDE support is drawn by :func:`distributed_systematic_resample`
      (``replicated=True``) from the training weights of every pool; each
      rank fills the rows it owns and a sum over the group joins them, so
      every rank fits the identical ``shared_support``-point KDE;
    * each rank redraws its own chains' pools from that KDE with its
      :func:`rank_generator`.

    Returns ``epoch(generator, pools_local, hat_eps) -> (pools_local, kde,
    hat_eps)``, the signature of the one-device epoch."""
    from ..models.kde import KernelDensity
    from ..samplers.aglmcmc import _redraw_chunks, _training_log_w

    anneal = sharded_hat_eps_update(cfg.alpha, cfg.hat_eps_T, mesh)

    def epoch(generator, pools, hat_eps):
        C, P = pools.dis.shape
        chunk = redraw_chunk if (redraw_chunk and redraw_chunk < C) else C
        if C % chunk:
            raise ValueError(f"chains a rank ({C}) must be divisible by "
                             f"redraw_chunk={redraw_chunk}")
        with annotate("glabc.epoch"):
            with annotate("glabc.epoch.anneal"):
                hat_eps = anneal(pools.dis, hat_eps)
            with annotate("glabc.epoch.support"):
                w = torch.exp(_training_log_w(problem, pools, hat_eps)
                              .to(torch.float64))
                w = torch.where(torch.isnan(w), torch.zeros_like(w), w)
                idx = distributed_systematic_resample(
                    w, shared_support, mesh, generator, replicated=True)
                n_local = C * P
                mine = (idx // n_local) == check_mesh(mesh)[0]
                loc = torch.where(mine, idx % n_local, torch.zeros_like(idx))
                rows = pools.theta[loc // P, loc % P]
                support = _all_sum(torch.where(mine[:, None], rows,
                                               torch.zeros_like(rows)), mesh)
                kde = KernelDensity.fit(support, None, bandwidth="silverman")
                gen = rank_generator(generator, mesh)
            pools = _redraw_chunks(problem, cfg, gen, kde, C, P, chunk)
        return pools, kde, hat_eps

    return epoch


def _sharded_adam_step(flow, opt, train_x: torch.Tensor, mesh):
    """One Adam step of forward KL with the gradient averaged over the
    group: every rank takes the same step, or (a non-finite mean loss)
    none.  Returns the mean loss."""
    world = check_mesh(mesh)[1]
    opt.zero_grad(set_to_none=True)
    loss = flow.forward_kld(train_x.detach())
    mean = _all_sum(loss.detach(), mesh) / world
    if bool(torch.isfinite(mean)):
        loss.backward()
        for p in flow.parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = torch.nan_to_num(_all_sum(g, mesh) / world)
        opt.step()
    return mean


def make_sharded_flow_trainer(problem, cfg, mesh):
    """Data-parallel :func:`~glabc_tpu_torch.samplers.glmcmc_nf.
    make_flow_trainer`: each rank draws ``batch_size * step_size / world``
    flow proposals with its :func:`rank_generator`, simulates, weighs and
    systematically resamples its shard, and the forward-KL gradients are
    averaged over the group.  Returns ``train(flow, opt, generator) ->
    loss``; the flow and the optimizer stay identical on every rank."""
    world = check_mesh(mesh)[1]
    local_n = max(1, cfg.batch_size * cfg.step_size // world)

    def train(flow, opt, generator):
        from ..ops.resampling import systematic_resample

        gen = rank_generator(generator, mesh)
        pool, log_q = flow(local_n, gen)
        nan_row = torch.isnan(pool).any(dim=-1)
        pool_safe = torch.where(nan_row[:, None], torch.zeros_like(pool),
                                pool)
        x = problem.simulate(pool_safe, gen)
        log_w = (problem.prior_log_prob(pool)
                 + problem.kernel_log_prob(problem.discrepancy(x)) - log_q)
        w = torch.exp(log_w.to(torch.float64))
        w = torch.where(nan_row | torch.isnan(w), torch.zeros_like(w), w)
        idx = systematic_resample(w / torch.sum(w), local_n, gen)
        return _sharded_adam_step(flow, opt, pool_safe[idx], mesh)

    return train


def make_sharded_chain_state_trainer(mesh):
    """Data-parallel chain-state refit: ``train(flow, opt, states_local)
    -> loss``, one Adam step of forward KL on every rank's chain states
    with the gradients averaged over the group (equal shards: the gradient
    of the loss over all states)."""

    def train(flow, opt, states_local):
        return _sharded_adam_step(flow, opt, states_local, mesh)

    return train
