"""``k1_roofline``: K1's least time over its profiled device time, in %.

The least time is the larger of the bytes K1 must move over 3.35 TB/s and
the 32-bit operations its chain-steps' moves need over one a lane a clock
(``harness/peaks.py``), for the work the window's jobs did: their
transitions and, from the returned ``global_attempts``, how many took the
iSIR move.  Where the trace holds fewer K1 launches than the jobs ran, the
work is scaled to the launches it holds.  None without a K1 launch."""

from perfbench.harness import peaks

KERNEL = "mixture_glmcmc_kernel"


def read(rc):
    spans = rc.timeline.kernels(KERNEL)
    job = getattr(rc.job, "global_attempts", None)
    if not spans or not job:
        return None
    per_job = -(-(rc.job.n_ite - 1) // rc.job.T)
    launches = per_job * len(rc.job.work)
    seen = min(len(spans), launches) / launches
    d, B = rc.job.pb["theta_dim"], rc.job.smp["batch_size"]
    ops = peaks.transition_ops_mix(d, B, True, sum(rc.job.work),
                                   sum(rc.job.global_attempts))
    least, _ = peaks.bound_s(peaks.k1_bytes(rc.job.C, d, launches), ops)
    busy = sum(e - s for s, e, _ in spans) * 1e-6
    return 100.0 * least * seen / busy
