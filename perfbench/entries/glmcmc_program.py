"""MA(2) GLMCMC through the generic fused kernel (K8): ``run_fused_program``.

The contract of ``glmcmc_fused.py``.  A job is one call of the entry with
the cell's traffic: ``num_chains`` chains of ``num_ite`` states from
``theta0``, each chain's starting dataset ``y0`` simulated by the
reference (``perfbench/reference/ma2.py``) at ``theta0`` on the run's seed
(the same for every job), the kernel keyed by a seed of the job's own; the
final states and the move counters come back to the host.  ``rows_per_job``
chains of each job, drawn from the run's seed, are kept with their final
dataset and log-kernel (the result's ``final_carry``) and, once the window
has closed, replayed from the same inputs by the reference; a chain
mismatches when its final theta, dataset or log-kernel differs from the
reference's by more than ``1e-5 max(1, |x|)`` or any of its three counters
differs.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.entries.glmcmc_fused import _WARM, job_seed

DRY = {"num_chains": 128, "num_ite": 17, "steps_per_call": 8,
       "rows_per_job": 16}
_Y0_CHUNK = 32768         # chains a reference simulation of y0 takes at once


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
        if (self.n_ite - 1) % self.T:
            raise ValueError("the reference replays whole launches: num_ite "
                             "- 1 must be a multiple of steps_per_call")
        self.work = []           # transitions of each job in the window
        self.global_attempts = []
        self.kept = []           # (kernel seed, chains, theta, y, logk, ...)
        self.rng = np.random.default_rng([ctx.seed, 1])

    # -------------------------------------------------------------- set-up
    def setup(self):
        from glabc_tpu_torch import MA2Problem
        from perfbench.reference.ma2 import Problem, simulate

        pb, dev = self.pb, self.ctx.device
        self.problem = MA2Problem(epsilon=pb["epsilon"],
                                  num_draws=pb["num_draws"],
                                  y_obs=pb["y_obs"])
        self.program = self.problem.tile_program(
            lp_scale=self.smp["lp_scale"])
        self.theta0 = np.asarray(self.tr["theta0"], np.float32)
        ref, th = Problem.from_config(pb), torch.as_tensor(self.theta0,
                                                           device=dev)
        y0 = []
        for c0 in range(0, self.C, _Y0_CHUNK):
            chain = torch.arange(c0, min(c0 + _Y0_CHUNK, self.C), device=dev)
            y0.append(simulate(ref, self.ctx.seed, chain, 0,
                               th.expand(chain.shape[0], -1)).cpu())
        self.y0 = torch.cat(y0).numpy()
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(self.ctx.seed)

    def _run(self, kseed: int):
        from glabc_tpu_torch.samplers.fused_program import run_fused_program

        s = self.smp
        return run_fused_program(
            self.problem, self.program, self.gen, self.n_ite, self.theta0,
            y0=self.y0, global_frequency=self.tr["global_frequency"],
            batch_size=s["batch_size"], num_chains=self.C,
            steps_per_call=self.T, block_chains=s["block_chains"],
            collect_history=False, seed=kseed, algorithm=s["algorithm"],
            device=self.ctx.device)

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
        at = torch.as_tensor(idx, device=self.ctx.device)
        _, y, logk = res.final_carry
        self.kept.append((kseed, idx, res.thetas[idx, -1, :].copy(),
                          y[:, at].T, logk[at],
                          c.global_attempts[idx].copy(),
                          c.global_accepts[idx].copy(),
                          c.local_accepts[idx].copy()))

    def release(self):
        self.y0_rows = np.concatenate([self.y0[k[1]] for k in self.kept])
        self.y0 = None

    # -------------------------------------------------------------- check
    def reference(self, dtype=torch.float32):
        """The reference's final states (theta, y, log K side by side) and
        counters of the kept rows."""
        from perfbench.reference.ma2 import Moves, Problem, replay

        dev = self.ctx.device
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        pb = Problem.from_config(self.pb)
        s = self.smp
        mv = Moves.create(pb, s["batch_size"], self.tr["global_frequency"],
                          s["lp_scale"])
        seeds = torch.as_tensor(np.concatenate(
            [np.full(len(k[1]), k[0], np.int64) for k in self.kept]),
            device=dev)
        chain = torch.as_tensor(np.concatenate([k[1] for k in self.kept]),
                                device=dev)
        th0 = torch.as_tensor(self.theta0, device=dev).expand(
            chain.shape[0], -1)
        y0 = torch.as_tensor(self.y0_rows, device=dev)
        th, y, lk, counts = replay(pb, mv, seeds, chain, th0, y0,
                                   self.n_ite - 1, dtype)
        return torch.cat([th, y, lk[:, None]], dim=1), counts

    def _program(self):
        dev = self.ctx.device
        cat = lambda i: torch.as_tensor(np.concatenate(
            [k[i] for k in self.kept]), device=dev)
        state = torch.cat([cat(2), torch.cat([k[3] for k in self.kept]),
                           torch.cat([k[4] for k in self.kept])[:, None]],
                          dim=1)
        return state, [cat(i).to(torch.int64) for i in (5, 6, 7)]

    def check(self, control: bool = False) -> dict:
        """``chain_mismatch_share``: the share of kept chains that differ
        from the reference.  ``control=True`` judges the reference computed
        in bfloat16 in the program's place."""
        want, want_c = self.reference()
        got, got_c = (self.reference(torch.bfloat16) if control
                      else self._program())
        from perfbench.harness.compare import mismatch_share

        return {"chain_mismatch_share": mismatch_share(got, got_c, want,
                                                       want_c)}
