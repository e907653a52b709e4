"""AGLMCMC with shared adaptation through the mixed kernel K5:
``run_aglmcmc_fused_mixed`` (``global_frequency < 1``), on one chip or,
under ``mesh=``, on every card of the cell.

A job is one call of the entry with the cell's traffic: ``num_chains``
chains (over every rank) of ``num_ite`` states from ``theta0``, segments
of ``round(step_size / gf)`` steps with a shared adaptation epoch between
two; the final states, counters and thresholds come back to the caller.
Every job draws its inputs from a generator seeded by the run's seed and
the job's number, alike on every rank.

What the window's last job produced is held against
``perfbench/reference/aglmcmc.py`` once the window has closed.  A tap
keeps references (no copies, no work) to what the job's shared epochs and
K5 launches received and returned; epoch ``k`` (drawn from the seed)
and the launch after it are checked:

* ``eps_gap``: every epoch's threshold against the reference's anneal of
  the pools that epoch received (every rank's), relative; on a mesh also
  the spread of the thresholds over the ranks;
* ``support_bad_share``: how far epoch ``k``'s KDE support is from a
  systematic resample of every rank's pool rows by the reference's
  weights, and the support rows in which a rank differs from rank 0;
* ``bandwidth_gap``: the KDE's bandwidth against the reference's
  Silverman bandwidth of that support, relative;
* ``density_gap``: the widest relative gap of the discrepancy, the KDE
  density and the weight of ``density_rows`` new pool rows of each rank;
* ``k5_mismatch_share``: ``k5_rows`` chains of each rank replayed through
  the launch after epoch ``k`` from the state it received: the share whose
  final theta differs by more than ``1e-5 max(1, |theta|)`` or whose
  counters differ.

The reference follows the program from the program's own state: the pool
rows (draws) and the state that each check starts from are the program's;
every threshold, weight, density and move is worked out again.
"""

from __future__ import annotations

import numpy as np
import torch

DRY = {"num_chains_per_rank": 128, "num_ite": 161, "warm_ite": 81,
       "step_size": 20, "shared_support": 64, "redraw_chunk": 32,
       "density_rows": 512, "k5_rows": 64}


def job_seed(seed: int, j: int) -> int:
    return (seed * 0x9E3779B1 + j * 0x85EBCA77 + 7) % 2**62


class Tap:
    """References to what one job's epochs and K5 launches received and
    returned."""

    def __init__(self, k: int):
        self.k = k
        self.reset()

    def reset(self):
        self.eps = []        # (dis in, threshold in, threshold out)
        self.epoch = None    # (pools in, pools out, kde) of epoch k
        self.launch = None   # launch k's (seed, step0, chain0, state in, out)
        self.n_launch = 0

    def epoch_factory(self, factory):
        def make(*args, **kwargs):
            epoch = factory(*args, **kwargs)

            def tapped(generator, pools, hat_eps):
                out = epoch(generator, pools, hat_eps)
                self.eps.append((pools.dis, hat_eps, out[2]))
                if len(self.eps) == self.k:
                    self.epoch = (pools, out[0], out[1])
                return out

            return tapped

        return make

    def launches(self, run):
        def tapped(kern, seed, res, ptheta, px, plogw, plogk, theta, y, logk,
                   *, step0=0, chain0=0):
            out = run(kern, seed, res, ptheta, px, plogw, plogk, theta, y,
                      logk, step0=step0, chain0=chain0)
            if self.n_launch == self.k:
                self.launch = (seed, step0, chain0, (theta, y, logk),
                               out[:6])
            self.n_launch += 1
            return out

        return tapped


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        conf, tr = ctx.cell.config, dict(ctx.cell.traffic)
        if ctx.dry:
            tr.update(DRY)
            tr["num_chains"] = DRY["num_chains_per_rank"] * ctx.world
        self.pb, self.smp, self.tr = conf["problem"], conf["sampler"], tr
        self.C, self.n_ite = int(tr["num_chains"]), int(tr["num_ite"])
        s = self.smp
        self.step_size = int(tr.get("step_size", s["step_size"]))
        self.support = int(tr.get("shared_support", s["shared_support"]))
        self.redraw_chunk = int(tr.get("redraw_chunk", s["redraw_chunk"]))
        gf = float(tr["global_frequency"])
        self.seg = max(1, int(round(self.step_size / gf)))
        self.segments = -(-(self.n_ite - 1) // self.seg)
        rng = np.random.default_rng([ctx.seed, 2])
        self.k = int(rng.integers(1, self.segments))    # epoch checked
        self.check_seed = int(rng.integers(0, 2**62))
        self.work = []
        self.tap = Tap(self.k)

    # -------------------------------------------------------------- set-up
    def setup(self):
        import glabc_tpu_torch.parallel.sharded as sharded
        import glabc_tpu_torch.samplers.aglmcmc as agl
        from glabc_tpu_torch import DiagGaussian, MixtureProblem
        from glabc_tpu_torch.ops.kernels.pool_isir_mixed_kernel import \
            PoolISIRMixed

        self.problem = MixtureProblem(self.pb["epsilon"])
        ip = self.smp["initial_proposal"]
        self.ip = DiagGaussian.create(self.pb["theta_dim"], ip["loc"],
                                      ip["log_scale"],
                                      device=self.ctx.device)
        self._patched = [(agl, "make_shared_epoch_fn"),
                         (sharded, "make_sharded_shared_epoch"),
                         (PoolISIRMixed, "run")]
        self._originals = [getattr(o, n) for o, n in self._patched]
        agl.make_shared_epoch_fn = self.tap.epoch_factory(
            agl.make_shared_epoch_fn)
        sharded.make_sharded_shared_epoch = self.tap.epoch_factory(
            sharded.make_sharded_shared_epoch)
        PoolISIRMixed.run = self.tap.launches(PoolISIRMixed.run)

    def _run(self, j: int, num_ite: int):
        from glabc_tpu_torch.samplers.aglmcmc_fused import \
            run_aglmcmc_fused_mixed

        s, tr = self.smp, self.tr
        gen = torch.Generator(device=self.ctx.device)
        gen.manual_seed(job_seed(self.ctx.seed, j))
        self.tap.reset()
        return run_aglmcmc_fused_mixed(
            self.problem, gen, num_ite, np.asarray(tr["theta0"], np.float32),
            self.ip, global_frequency=tr["global_frequency"],
            batch_size=s["batch_size"], step_size=self.step_size,
            alpha=s["alpha"], hat_eps_T=s["hat_eps_T"],
            num_chains=self.C, collect_history=False,
            seed=job_seed(self.ctx.seed, j) ^ 0x5DEECE66D,
            mesh=self.ctx.mesh, lp_scale=s["lp_scale"],
            shared_support=self.support, redraw_chunk=self.redraw_chunk,
            device=self.ctx.device)

    def warm(self):
        """One segment and one epoch of the cell's shapes."""
        self._run(-1, int(self.tr["warm_ite"]))

    def first_estimate(self, warm_s: float) -> float:
        return warm_s * (self.n_ite - 1) / (int(self.tr["warm_ite"]) - 1)

    # -------------------------------------------------------------- window
    def job(self, j: int):
        self._run(j, self.n_ite)
        self.work.append(self.C * (self.n_ite - 1))

    def release(self):
        """Takes the tap out; what it holds outlives the window."""
        for (owner, name), orig in zip(self._patched, self._originals):
            setattr(owner, name, orig)

    # -------------------------------------------------------------- check
    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` joined along dim 0, in rank order."""
        if self.ctx.mesh is None:
            return x
        from glabc_tpu_torch.parallel.mesh import gather_chains

        return gather_chains(x.reshape(1) if x.dim() == 0 else x,
                             self.ctx.mesh)

    def _reduce(self, x: float, op: str) -> float:
        from perfbench.harness.main import reduce_ranks

        return reduce_ranks(x, op, self.ctx.mesh, self.ctx.device)

    def check(self, control: bool = False) -> dict:
        """The five numbers of the module docstring.  ``control=True``
        judges the reference computed in bfloat16 in the program's place."""
        from perfbench.harness.compare import mismatch_share
        from perfbench.reference import aglmcmc as ref
        from perfbench.reference.mixture import Problem

        tap, s, dev = self.tap, self.smp, self.ctx.device
        if tap.epoch is None or tap.launch is None:
            raise RuntimeError(f"the job ran no epoch {self.k} or no launch "
                               "after it")
        pb = Problem.from_config(self.pb)
        low = torch.bfloat16
        rng = np.random.default_rng(self.check_seed)
        root = self.ctx.rank == 0

        # ε̂ of every epoch from every rank's pool discrepancies
        eps_gap = 0.0
        for dis, e_in, e_out in tap.eps:
            e_in = float(e_in)
            all_dis = self._gather(dis)
            want = ref.anneal(all_dis, e_in, s["alpha"], s["hat_eps_T"])
            got = (ref.anneal(all_dis, e_in, s["alpha"], s["hat_eps_T"], low)
                   if control else float(e_out))
            outs = self._gather(e_out.reshape(1).to(torch.float64))
            spread = float((outs.max() - outs.min()) / outs.abs().max())
            eps_gap = max(eps_gap, abs(got - want) / want, spread)
            del all_dis

        # epoch k: support, bandwidth
        pools_in, pools_out, kde = tap.epoch
        C, P, d = pools_out.theta.shape
        e_k = float(tap.eps[self.k - 1][2])
        theta_all = self._gather(pools_in.theta)
        dis_all = self._gather(pools_in.dis)
        logq_all = self._gather(pools_in.log_q)
        X = kde.X
        Xs = self._gather(X).reshape(self.ctx.world, *X.shape)
        apart = int((Xs != Xs[0:1]).any(dim=-1).sum())
        X0 = Xs[0]
        u0 = float(rng.random())
        bad = apart / X0.shape[0]
        if root:
            w = ref.training_weights(theta_all, dis_all, logq_all, e_k)
            X_got = X0
            if control:
                wl = ref.training_weights(theta_all, dis_all, logq_all, e_k,
                                          low)
                idx = ref.systematic(wl, X0.shape[0], u0)
                X_got = theta_all.reshape(-1, d)[idx].to(low).float()
            bad += ref.support_bad_share(theta_all, w, X_got)
            del w
        del theta_all, dis_all, logq_all
        h = ref.silverman(X0)
        h_got = (ref.silverman(X0, low) if control
                 else self._gather(kde.bandwidth.reshape(1, -1)))
        bw_gap = float(((h_got.to(torch.float64) - h).abs() / h).max())

        # epoch k's new pools of this rank
        rows = torch.as_tensor(rng.integers(0, C * P, int(
            self.tr["density_rows"])), device=dev)
        th = pools_out.theta.reshape(-1, d)[rows]
        xx = pools_out.x.reshape(-1, pools_out.x.shape[-1])[rows]
        want = ref.pool_rows(pb, th, xx, X0, h)
        got = (ref.pool_rows(pb, th, xx, X0, h, low) if control else
               (pools_out.dis.reshape(-1)[rows],
                pools_out.log_q.reshape(-1)[rows],
                pools_out.log_w.reshape(-1)[rows]))
        dens_gap = max(ref.widest_gap(g, w_) for g, w_ in zip(got, want))

        # the launch after epoch k, on k5_rows chains of this rank
        seed, step0, chain0, (theta, y, logk), out = tap.launch
        cols = torch.as_tensor(rng.integers(0, C, int(self.tr["k5_rows"])),
                               device=dev)
        state = (theta[:, cols].T, y[:, cols].T, logk[cols])
        pool = (pools_out.theta[cols], pools_out.x[cols],
                pools_out.log_w[cols], pools_out.dis[cols])
        chain = cols.to(torch.int64) + int(chain0)
        args = (pb, int(s["batch_size"]), float(self.tr["global_frequency"]),
                float(s["lp_scale"]), int(seed), chain, int(step0), state,
                pool, X0, h.to(torch.float32))
        (w_th, _, _), w_c = ref.mixed_replay(*args)
        if control:
            (g_th, _, _), g_c = ref.mixed_replay(*args, dtype=low)
        else:
            g_th = out[0][:, cols].T
            g_c = [c[cols].to(torch.int64) for c in out[3:6]]
        share = mismatch_share(g_th, g_c, w_th, w_c)

        world = self.ctx.world
        return {"eps_gap": self._reduce(eps_gap, "max"),
                "support_bad_share": self._reduce(bad, "max"),
                "bandwidth_gap": self._reduce(bw_gap, "max"),
                "density_gap": self._reduce(dens_gap, "max"),
                "k5_mismatch_share": self._reduce(share, "sum") / world}
