"""GLMCMC through the fused K1 kernel: ``run_glmcmc_fused``.

A job is one call of the entry with the cell's traffic: ``num_chains``
chains of ``num_ite`` states from ``theta0``, each chain's starting dataset
``y0`` drawn by the harness from the run's seed (the same for every job),
the kernel keyed by a seed of the job's own; the final states and the move
counters come back to the host.  ``rows_per_job`` chains of each job, drawn
from the run's seed, are kept and, once the window has closed, replayed
from the same inputs by ``perfbench/reference/glmcmc.py``; a chain
mismatches when its final theta differs from the reference's by more than
``1e-5 max(1, |theta|)`` or any of its three counters differs.
"""

from __future__ import annotations

import numpy as np
import torch

DRY = {"num_chains": 512, "num_ite": 65, "steps_per_call": 32,
       "rows_per_job": 16}
_WARM = 2**40             # the warm job's kernel seed stream


def job_seed(seed: int, j: int) -> int:
    """The kernel seed of job ``j`` of a run (non-negative, < 2**62)."""
    return (seed * 0x9E3779B1 + j * 0x85EBCA77 + 1) % 2**62


class Cell:
    def __init__(self, ctx):
        if ctx.world != 1:
            raise ValueError("this entry runs on one chip")
        self.ctx = ctx
        conf, tr = ctx.cell.config, dict(ctx.cell.traffic)
        if ctx.dry:
            tr.update(DRY)
        self.pb, self.smp, self.tr = conf["problem"], conf["sampler"], tr
        self.C, self.n_ite = int(tr["num_chains"]), int(tr["num_ite"])
        self.T = int(tr.get("steps_per_call", self.smp["steps_per_call"]))
        self.work = []           # transitions of each job in the window
        self.global_attempts = []
        self.kept = []           # (kernel seed, chains, theta, g_att, ...)
        self.rng = np.random.default_rng([ctx.seed, 1])

    # -------------------------------------------------------------- set-up
    def setup(self):
        from glabc_tpu_torch import MixtureProblem

        pb, dev = self.pb, self.ctx.device
        self.problem = MixtureProblem(pb["epsilon"])
        self.theta0 = np.asarray(self.tr["theta0"], np.float32)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.ctx.seed)
        th = torch.as_tensor(self.theta0, device=dev).expand(self.C, -1)
        sd = float(np.sqrt(np.float32(pb["noise_var"])))
        y0 = th.abs() + sd * torch.randn((self.C, pb["theta_dim"]),
                                         generator=gen, device=dev)
        self.y0 = y0.cpu().numpy()
        self.gen = gen

    def _run(self, kseed: int):
        from glabc_tpu_torch.samplers.glmcmc_fused import run_glmcmc_fused

        s = self.smp
        return run_glmcmc_fused(
            self.problem, self.gen, self.n_ite, self.theta0, y0=self.y0,
            ip_loc=s["ip_loc"], ip_scale=s["ip_scale"],
            lp_scale=s["lp_scale"], global_frequency=self.tr["global_frequency"],
            batch_size=s["batch_size"], num_chains=self.C,
            steps_per_call=self.T, collect_history=False, seed=kseed,
            kernel=s["kernel"], device=self.ctx.device)

    def warm(self):
        self._run(job_seed(self.ctx.seed, _WARM))

    def first_estimate(self, warm_s: float) -> float:
        return warm_s

    # -------------------------------------------------------------- window
    def job(self, j: int):
        kseed = job_seed(self.ctx.seed, j)
        res = self._run(kseed)
        c = res.counts
        self.work.append(self.C * (self.n_ite - 1))
        self.global_attempts.append(int(c.global_attempts.sum(
            dtype=np.int64)))
        idx = self.rng.integers(0, self.C, int(self.tr["rows_per_job"]))
        self.kept.append((kseed, idx, res.thetas[idx, -1, :].copy(),
                          c.global_attempts[idx].copy(),
                          c.global_accepts[idx].copy(),
                          c.local_accepts[idx].copy()))

    def release(self):
        self.y0_rows = np.concatenate([self.y0[k[1]] for k in self.kept])
        self.y0 = None

    # -------------------------------------------------------------- check
    def reference(self, dtype=torch.float32):
        """The reference's final states and counters of the kept rows."""
        from perfbench.reference.glmcmc import Moves, replay
        from perfbench.reference.mixture import Problem

        dev = self.ctx.device
        pb = Problem.from_config(self.pb)
        s = self.smp
        mv = Moves.create(s["batch_size"], self.tr["global_frequency"],
                          s["lp_scale"], s["ip_loc"], s["ip_scale"])
        seeds = torch.as_tensor(np.concatenate(
            [np.full(len(k[1]), k[0], np.int64) for k in self.kept]),
            device=dev)
        chain = torch.as_tensor(np.concatenate([k[1] for k in self.kept]),
                                device=dev)
        th0 = torch.as_tensor(self.theta0, device=dev).expand(
            chain.shape[0], -1)
        y0 = torch.as_tensor(self.y0_rows, device=dev)
        th, _, _, counts = replay(pb, mv, seeds, chain, th0, y0,
                                  self.n_ite - 1, dtype)
        return th, counts

    def _program(self):
        dev = self.ctx.device
        cat = lambda i: torch.as_tensor(np.concatenate(
            [k[i] for k in self.kept]), device=dev)
        return cat(2), [cat(i).to(torch.int64) for i in (3, 4, 5)]

    def check(self, control: bool = False) -> dict:
        """``chain_mismatch_share``: the share of kept chains that differ
        from the reference.  ``control=True`` judges the reference computed
        in bfloat16 in the program's place."""
        want_th, want_c = self.reference()
        got_th, got_c = (self.reference(torch.bfloat16) if control
                         else self._program())
        from perfbench.harness.compare import mismatch_share

        return {"chain_mismatch_share": mismatch_share(got_th, got_c, want_th,
                                                       want_c)}

