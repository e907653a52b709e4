"""GLMALA: iSIR global move + ABC-MALA local move, plain torch path.

Port of ``glabc_tpu/samplers/glmala.py`` (reference ``glabcmcmc/
GLMALA.py:118-230``).  The local move is Metropolis-adjusted Langevin on a
Gaussian synthetic-likelihood surrogate of the ABC log-posterior, its drift
gradient estimated from simulations:

* ``grad_mode='crn_fd'``: central differences per coordinate with common
  random numbers: the ``+fd`` and ``-fd`` simulations of a coordinate draw
  the same noise (the generator state is restored between the two calls),
  and each coordinate draws its own; the unbiased (ddof=1) variance over
  ``num_grad`` replicates (``GLMALA.py:46-95``);
* ``grad_mode='autodiff'``: autograd through the reparameterised simulator
  of the same surrogate;
* the prior gradient is ``problem.prior_grad`` (autograd).

MH correction (``GLMALA.py:97-116,190-193``): forward term the standard
normal log-density of the drawn ``z``, reverse term that of ``(theta -
theta' - grad' tau^2/2) / tau``; the ``1/tau`` Jacobians cancel.  The
cached gradient stays stale after an accepted global move, as in the
reference (``GLMALA.py:183-199``), unless ``refresh_grad_after_global``.

Every step draws each chain's coin, runs both moves for all chains and
selects per chain; randomness comes from one ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .._device import check_generator, resolve_device
from .base import MoveCounts, SamplerResult, StepOut, _select, isir_move

__all__ = ["GLMALAConfig", "GLMALACarry", "synthetic_likelihood_grad",
           "build_glmala_step", "init_glmala_carry", "run_glmala"]

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class GLMALAConfig:
    global_frequency: float = 0.8
    batch_size: int = 5
    tau: float = 0.3
    num_grad: int = 100
    fd_step: float = 0.1          # reference d=1e-1 (GLMALA.py:46)
    grad_mode: str = "crn_fd"     # 'crn_fd' (parity) | 'autodiff'
    refresh_grad_after_global: bool = False


def _std_normal_logpdf(z):
    return torch.sum(-0.5 * _LOG_2PI - 0.5 * z * z, dim=-1)


def sl_log_prob(problem, ys) -> torch.Tensor:
    """Gaussian synthetic-likelihood log-density from simulated datasets
    ``ys (..., num_grad, d_y)`` at one theta each (``GLMALA.py:86-94``)."""
    dis = problem.discrepancy(ys)                      # (..., num_grad)
    mu = torch.mean(dis, dim=-1)
    var = torch.var(dis, dim=-1, correction=1)
    s = var + problem.epsilon ** 2
    return -0.5 * torch.log(s) - 0.5 * mu * mu / s


def synthetic_likelihood_grad(problem, generator, theta, num_grad: int,
                              fd_step: float = 0.1, mode: str = "crn_fd"):
    """``grad log p_ABC(theta)`` (synthetic likelihood + prior) for every
    row of ``theta (C, d)``."""
    C, d = theta.shape
    if mode == "autodiff":
        with torch.enable_grad():
            th = theta.detach().clone().requires_grad_(True)
            rep = th[:, None, :].expand(C, num_grad, d)
            lp = sl_log_prob(problem, problem.simulate(rep, generator))
            (grad_ll,) = torch.autograd.grad(lp.sum(), th)
    elif mode == "crn_fd":
        step = fd_step * torch.eye(d, dtype=theta.dtype, device=theta.device)
        shape = (C, d, num_grad, d)
        th_p = (theta[:, None, :] + step)[:, :, None, :].expand(shape)
        th_m = (theta[:, None, :] - step)[:, :, None, :].expand(shape)
        state = generator.get_state()
        lp_p = sl_log_prob(problem, problem.simulate(th_p, generator))
        after = generator.get_state()
        generator.set_state(state)          # the same draws: CRN
        lp_m = sl_log_prob(problem, problem.simulate(th_m, generator))
        generator.set_state(after)
        grad_ll = (lp_p - lp_m) / (2.0 * fd_step)
    else:
        raise ValueError(f"grad_mode must be 'crn_fd' or 'autodiff', got "
                         f"{mode!r}")
    with torch.enable_grad():
        prior_g = problem.prior_grad(theta).to(theta.device)
    return grad_ll.detach() + prior_g


class GLMALACarry(NamedTuple):
    theta: torch.Tensor        # (C, d)
    y: torch.Tensor            # (C, d_y)
    log_kernel: torch.Tensor   # (C,)
    grad: torch.Tensor         # (C, d) cached gradient (may be stale)
    generator: torch.Generator
    counts: MoveCounts

    def to_arrays(self) -> dict:
        out = {"theta": self.theta, "y": self.y, "log_kernel": self.log_kernel,
               "grad": self.grad, "rng_state": self.generator.get_state()}
        out.update({f"counts.{k}": v
                    for k, v in self.counts._asdict().items()})
        return out

    @classmethod
    def from_arrays(cls, arrays, generator, device) -> "GLMALACarry":
        t = lambda k: torch.as_tensor(arrays[k], device=device)
        generator.set_state(torch.as_tensor(arrays["rng_state"]))
        counts = MoveCounts(*(t(f"counts.{k}") for k in MoveCounts._fields))
        return cls(t("theta"), t("y"), t("log_kernel"), t("grad"), generator,
                   counts)


def build_glmala_step(problem, importance_proposal, cfg: GLMALAConfig):
    """Batched transition ``step(carry) -> (carry, StepOut)``."""
    tau = cfg.tau

    def grad_at(gen, theta):
        return synthetic_likelihood_grad(problem, gen, theta, cfg.num_grad,
                                         cfg.fd_step, cfg.grad_mode)

    def step(carry: GLMALACarry):
        gen = carry.generator
        theta, y, lk, grad = carry.theta, carry.y, carry.log_kernel, carry.grad
        C = theta.shape[0]
        is_global = torch.rand(C, generator=gen,
                               device=theta.device) < cfg.global_frequency
        # global: iSIR; the gradient stays stale unless asked otherwise
        g_th, g_y, g_lk, g_acc = isir_move(problem, importance_proposal, gen,
                                           theta, y, lk, cfg.batch_size)
        g_grad = grad
        if cfg.refresh_grad_after_global:
            g_grad = _select(g_acc, grad_at(gen, g_th), grad)
        # local: MALA with the reverse-drift density
        z = torch.randn(theta.shape, generator=gen, device=theta.device)
        log_fwd = _std_normal_logpdf(z)
        th_p = z * tau + theta + grad * tau ** 2 / 2.0
        grad_p = grad_at(gen, th_p)
        y_p = problem.simulate(th_p, gen)
        lk_p = problem.kernel_log_prob(problem.discrepancy(y_p))
        log_rev = _std_normal_logpdf((theta - th_p - grad_p * tau ** 2 / 2.0)
                                     / tau)
        log_acc = (problem.prior_log_prob(th_p) + lk_p + log_rev
                   - problem.prior_log_prob(theta) - lk - log_fwd)
        l_acc = torch.log(torch.rand(C, generator=gen,
                                     device=theta.device)) < log_acc
        loc = (_select(l_acc, th_p, theta), _select(l_acc, y_p, y),
               torch.where(l_acc, lk_p, lk), _select(l_acc, grad_p, grad),
               l_acc)
        new = [_select(is_global, a, b)
               for a, b in zip((g_th, g_y, g_lk, g_grad, g_acc), loc)]
        counts = carry.counts.update(is_global, new[4])
        return (GLMALACarry(*new[:4], gen, counts),
                StepOut(new[0], new[4], is_global))

    return step


def init_glmala_carry(problem, generator, theta0, cfg: GLMALAConfig, y0=None,
                      num_chains: int = 1, device=None) -> GLMALACarry:
    """Batched carry: ``theta0`` broadcast (or ``(C, d)``), datasets
    simulated unless ``y0`` is given, and the gradient at ``theta0``
    computed at once (the reference computes the same estimator lazily at
    the first local move, ``GLMALA.py:183-184``)."""
    from .chain import init_chain_carry

    cc = init_chain_carry(problem, generator, theta0, y0, num_chains, device)
    grad0 = synthetic_likelihood_grad(problem, generator, cc.theta,
                                      cfg.num_grad, cfg.fd_step, cfg.grad_mode)
    return GLMALACarry(cc.theta, cc.y, cc.log_kernel, grad0, generator,
                       cc.counts)


def run_glmala(problem, generator, num_ite, theta0, importance_proposal,
               global_frequency=0.8, batch_size=5, tau=0.3, num_grad=100,
               y0=None, num_chains: int = 1, segment_size: int = 10_000,
               on_segment=None, grad_mode: str = "crn_fd",
               refresh_grad_after_global: bool = False,
               checkpoint_path: str | None = None, resume: bool = False,
               mesh=None, device=None) -> SamplerResult:
    """GLMALA, plain torch path.  Chains have length ``num_ite`` with the
    initial state at index 0.

    ``checkpoint_path``/``resume``: the carry (theta, y, kernel value,
    gradient, generator state, counts) is saved after every segment;
    ``resume=True`` continues where the run stopped, returning only the
    history after the resume point.

    ``mesh``: as in :func:`~glabc_tpu_torch.samplers.chain.
    sample_with_step`: every rank runs the whole one-device run and
    returns its result, bit for bit."""
    from .chain import _num_chains, drive_plain

    dev = resolve_device(device)
    check_generator(generator, dev)
    cfg = GLMALAConfig(global_frequency, batch_size, tau, num_grad,
                       grad_mode=grad_mode,
                       refresh_grad_after_global=refresh_grad_after_global)
    step = build_glmala_step(problem, importance_proposal.to(dev), cfg)
    return drive_plain(
        step, generator, num_ite, GLMALACarry,
        lambda: init_glmala_carry(problem, generator, theta0, cfg, y0,
                                  num_chains, dev),
        _num_chains(theta0, num_chains), segment_size, on_segment,
        checkpoint_path, resume, mesh, dev)
