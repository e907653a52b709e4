"""GLMCMC-NF: iSIR global proposal from a normalizing flow trained online,
plain per-step path, and the trainers the pooled drivers share.

Port of ``glabc_tpu/samplers/glmcmc_nf.py`` (reference ``glabcmcmc/
GLMCMC_NFs.py:43-186``): the global proposal is an affine coupling flow
(:class:`~glabc_tpu_torch.models.flows.CouplingFlow`), refit between
segments of ``round(step_size / global_frequency)`` steps by Adam steps of
forward KL; local moves are random-walk MH.  Each global move here draws
``batch_size`` fresh flow proposals (the pooled drivers in
``glmcmc_nf_fused.py`` restore the reference's pools).

* The optimizer is ``torch.optim.Adam(lr, weight_decay=wd)``: the decayed
  weights are added to the gradient before the moments (L2-coupled, not
  AdamW), which is what the JAX package's optax chain
  ``add_decayed_weights -> scale_by_adam -> scale(-lr)`` computes and what
  the reference's ``torch.optim.Adam(lr=5e-4, weight_decay=1e-5)`` is
  (``GLMCMC_NFs.py:63``).
* A NaN/inf training loss skips the update, optimizer state included
  (``GLMCMC_NFs.py:120-122``); NaN gradient entries of a finite loss become
  numbers (``nan_to_num``); NaN proposal rows get zero weight (``:83-85``).
* Training differentiates the plain flow (``CouplingFlow.forward_kld``);
  every other flow evaluation (sampling, ``log_prob``) is the K7 kernel on
  the card.

One ``torch.Generator`` feeds the flow's initialisation, the chains and the
training, in a fixed order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._device import check_generator, resolve_device
from ..models.distributions import DiagGaussian
from ..models.flows import CouplingFlow
from ..ops.resampling import systematic_resample
from ._fused_io import restore_epoch_ckpt, save_epoch_ckpt
from ._shard import ChainShard
from .base import (MoveCounts, SamplerResult, StepOut, _select, isir_move,
                   local_rw_move)
from .chain import ChainCarry, _num_chains, init_chain_carry

__all__ = ["GLMCMCNFConfig", "make_optimizer", "adam_step",
           "make_flow_trainer", "build_nf_step",
           "NFResult", "flow_state_arrays", "flow_state_from_arrays",
           "run_glmcmc_nf"]

_FLOW_PARAMS = ("loc", "log_scale", "w0", "b0", "w1", "b1", "w2", "b2")


@dataclasses.dataclass(frozen=True)
class GLMCMCNFConfig:
    global_frequency: float = 0.5
    batch_size: int = 5
    step_size: int = 200          # global moves per training epoch
    train_steps: int = 50         # max Adam epochs (reference Train_step)
    n_layers: int = 32
    hidden: int = 128
    learning_rate: float = 5e-4
    weight_decay: float = 1e-5
    support_retries: int = 0
    # 'flow_is': importance-resampled flow samples (GLMCMC_NFs.py:114-124);
    # 'chain_states': one Adam step on the chains' current states (the
    # chains are approximate posterior draws: no importance weights)
    train_on: str = "flow_is"
    train_iters_per_epoch: int = 1


def make_optimizer(flow: CouplingFlow, cfg: GLMCMCNFConfig):
    """Adam with the weight decay added to the gradient (L2-coupled)."""
    return torch.optim.Adam(flow.parameters(), lr=cfg.learning_rate,
                            weight_decay=cfg.weight_decay)


def adam_step(flow: CouplingFlow, opt, train_x: torch.Tensor) -> torch.Tensor:
    """One Adam step of forward KL on ``train_x (N, d)``; a non-finite loss
    leaves the flow and the optimizer state as they were.  Returns the
    loss (a device scalar)."""
    opt.zero_grad(set_to_none=True)
    loss = flow.forward_kld(train_x.detach())
    if bool(torch.isfinite(loss)):
        loss.backward()
        for p in flow.parameters():
            p.grad = torch.nan_to_num(p.grad)
        opt.step()
    return loss.detach()


def make_flow_trainer(problem, cfg: GLMCMCNFConfig):
    """One training epoch on flow proposals: ``batch_size * step_size``
    draws from the flow, simulated and weighted by ``prior + log K - log
    q``, systematically resampled, one Adam step.  Returns ``train(flow,
    opt, generator) -> loss``."""
    pool_n = cfg.batch_size * cfg.step_size

    def train(flow, opt, generator):
        pool, log_q = flow(pool_n, generator)
        nan_row = torch.isnan(pool).any(dim=-1)
        pool_safe = torch.where(nan_row[:, None], torch.zeros_like(pool),
                                pool)
        x = problem.simulate(pool_safe, generator)
        log_w = (problem.prior_log_prob(pool)
                 + problem.kernel_log_prob(problem.discrepancy(x)) - log_q)
        w = torch.exp(log_w.to(torch.float64))
        w = torch.where(nan_row | torch.isnan(w), torch.zeros_like(w), w)
        idx = systematic_resample(w / torch.sum(w), pool_n, generator)
        return adam_step(flow, opt, pool_safe[idx])

    return train


def build_nf_step(problem, local_proposal, cfg: GLMCMCNFConfig):
    """Batched transition under the current flow: ``step(flow, carry) ->
    (carry, StepOut)``.  Both moves run for every chain; the coin
    selects."""
    gf = cfg.global_frequency

    def step(flow, carry: ChainCarry):
        gen = carry.generator
        C = carry.theta.shape[0]
        is_global = torch.rand(C, generator=gen,
                               device=carry.theta.device) < gf
        g = isir_move(problem, flow, gen, carry.theta, carry.y,
                      carry.log_kernel, cfg.batch_size)
        loc = local_rw_move(problem, local_proposal, gen, carry.theta,
                            carry.y, carry.log_kernel, cfg.support_retries)
        theta, y, lk, accepted = (_select(is_global, a, b)
                                  for a, b in zip(g, loc))
        counts = carry.counts.update(is_global, accepted)
        return (ChainCarry(theta, y, lk, gen, counts),
                StepOut(theta, accepted, is_global))

    return step


@dataclasses.dataclass
class NFResult(SamplerResult):
    flow: Optional[CouplingFlow] = None
    loss_hist: Optional[np.ndarray] = None
    # fused driver only: the kernel state (theta (d, C), y (C, d),
    # log_kernel (C,), carried pool log-weight (C,))
    fused_state: Optional[tuple] = None


def flow_state_arrays(flow: CouplingFlow, opt) -> dict:
    """The flow's parameters and Adam's moments and step counts as named
    arrays, for a checkpoint."""
    out = {f"flow.{n}": getattr(flow, n).detach() for n in _FLOW_PARAMS}
    for n in _FLOW_PARAMS:
        st = opt.state.get(getattr(flow, n), {})
        for k in ("step", "exp_avg", "exp_avg_sq"):
            if k in st:
                out[f"opt.{n}.{k}"] = st[k]
    return out


def flow_state_from_arrays(arrays, cfg: GLMCMCNFConfig, device):
    """``(flow, opt)`` as :func:`flow_state_arrays` saved them."""
    flow = CouplingFlow(*(torch.as_tensor(arrays[f"flow.{n}"], device=device)
                          for n in _FLOW_PARAMS))
    opt = make_optimizer(flow, cfg)
    for n in _FLOW_PARAMS:
        if f"opt.{n}.step" in arrays:
            p = getattr(flow, n)
            opt.state[p] = {
                "step": torch.as_tensor(arrays[f"opt.{n}.step"],
                                        dtype=torch.float32),
                "exp_avg": torch.as_tensor(arrays[f"opt.{n}.exp_avg"],
                                           device=device),
                "exp_avg_sq": torch.as_tensor(arrays[f"opt.{n}.exp_avg_sq"],
                                              device=device)}
    return flow, opt


def new_flow(problem, generator, base, n_layers, hidden, flow, device):
    """The run's flow: ``flow`` when given (trained in place), else a fresh
    one over ``base`` drawn from ``generator``."""
    if flow is not None:
        return flow.to(device)
    return CouplingFlow.create(problem.theta_dim, n_layers, hidden,
                               base=base, generator=generator, device=device)


def run_glmcmc_nf(problem, generator, num_ite, theta0, local_proposal,
                  base: DiagGaussian | None = None, global_frequency=0.5,
                  batch_size=5, step_size=200, train_steps=50, y0=None,
                  num_chains: int = 1, n_layers: int = 32, hidden: int = 128,
                  on_segment=None, flow: CouplingFlow | None = None,
                  support_retries: int = 0, train_on: str = "flow_is",
                  train_iters_per_epoch: int = 1, mesh=None,
                  checkpoint_path: str | None = None,
                  resume: bool = False, device=None) -> NFResult:
    """GLMCMC-NF, plain per-step path.  Chains have length ``num_ite`` with
    the initial state at index 0.

    ``checkpoint_path``/``resume``: the flow, Adam's state, the chain carry
    and the generator are saved after every whole segment, before the epoch
    that follows it; ``resume=True`` replays that epoch and continues
    bitwise, returning only the history after the resume point.

    ``mesh``: a 1-D ``DeviceMesh``; every rank calls with the same
    arguments and generator seed.  The flow and the initial states come
    from the run's generator as on one device (each rank keeps its own
    chains); after them a rank's chains draw from its own generator, and
    each refit is data-parallel (``parallel.make_sharded_flow_trainer`` /
    ``make_sharded_chain_state_trainer``: gradients averaged over the
    group), so the flow stays the same on every rank and the chains match
    a one-device run in distribution.  Every rank returns the whole
    history, counts and loss history."""
    shard = ChainShard(_num_chains(theta0, num_chains), mesh)
    if train_on not in ("flow_is", "chain_states"):
        raise ValueError(f"train_on must be 'flow_is' or 'chain_states', got "
                         f"{train_on!r}")
    dev = resolve_device(device)
    check_generator(generator, dev)
    cfg = GLMCMCNFConfig(global_frequency, batch_size, step_size, train_steps,
                         n_layers, hidden, support_retries=support_retries,
                         train_on=train_on,
                         train_iters_per_epoch=train_iters_per_epoch)
    step = build_nf_step(problem, local_proposal.to(dev), cfg)
    seg_len = max(1, int(round(step_size / max(global_frequency, 1e-6))))
    ckpt_meta = {"sampler": "glmcmc_nf", "num_chains": num_chains,
                 "theta_dim": problem.theta_dim, "seg_len": seg_len,
                 "n_layers": n_layers, "hidden": hidden,
                 "train_on": train_on, **shard.meta}
    checkpoint_path = shard.path(checkpoint_path, resume)
    restored = (restore_epoch_ckpt(checkpoint_path, ckpt_meta)
                if resume and checkpoint_path is not None else None)
    if restored is None:
        flow = new_flow(problem, generator, base, n_layers, hidden, flow, dev)
        opt = make_optimizer(flow, cfg)
        cc = init_chain_carry(problem, generator, theta0, y0, num_chains,
                              dev)
        theta_init = cc.theta.cpu().numpy()[:, None, :]
        carry = ChainCarry(shard.keep(cc.theta), shard.keep(cc.y),
                           shard.keep(cc.log_kernel),
                           shard.local_generator(generator),
                           MoveCounts.zeros(shard.local, dev))
        losses, num_train, done = [], 0, 0
        pending_epoch = False
    else:
        arrays, done = restored
        flow, opt = flow_state_from_arrays(arrays, cfg, dev)
        carry = ChainCarry.from_arrays(
            arrays, shard.restore_rngs(arrays, generator), dev)
        losses = [float(x) for x in np.asarray(arrays["losses"]).ravel()]
        num_train = int(arrays["num_train"])
        theta_init = None
        pending_epoch = True
    if mesh is None:
        train, train_states = make_flow_trainer(problem, cfg), adam_step
    else:
        from ..parallel.sharded import (make_sharded_chain_state_trainer,
                                        make_sharded_flow_trainer)
        train = make_sharded_flow_trainer(problem, cfg, mesh)
        train_states = make_sharded_chain_state_trainer(mesh)
    host = lambda a: shard.gather_host(a, dev)

    blocks = []
    total = num_ite - 1
    while done < total:
        if pending_epoch:
            if num_train < train_steps:
                for _ in range(cfg.train_iters_per_epoch):
                    if train_on == "chain_states":
                        loss = train_states(flow, opt, carry.theta)
                    else:
                        loss = train(flow, opt, generator)
                    losses.append(float(loss))
                num_train += 1
            pending_epoch = False
        take = min(seg_len, total - done)
        seg = []
        for _ in range(take):
            carry, out = step(flow, carry)
            seg.append(out.theta)
        blocks.append(host(torch.stack(seg, dim=1).cpu().numpy()))
        if on_segment is not None:
            on_segment(blocks[-1], done)
        done += take
        if take == seg_len:
            if done < total:
                pending_epoch = True
            if checkpoint_path is not None:
                state = carry.to_arrays()
                state.update(shard.rng_arrays(generator, carry.generator))
                state.update(flow_state_arrays(flow, opt))
                state.update(num_train=num_train,
                             losses=np.asarray(losses, np.float64))
                save_epoch_ckpt(checkpoint_path, state, done, take, seg_len,
                                meta=ckpt_meta)

    head = [theta_init] if theta_init is not None else []
    thetas = (np.concatenate(head + blocks, axis=1) if head or blocks
              else np.zeros((num_chains, 0, problem.theta_dim), np.float32))
    return NFResult(thetas=thetas,
                    counts=MoveCounts(*(host(c.cpu().numpy())
                                        for c in carry.counts)),
                    final_carry=carry, flow=flow,
                    loss_hist=np.asarray(losses, np.float64))
