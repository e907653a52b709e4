"""``k8_roofline``: K8's least time over its profiled device time, in %.

The least time is the larger of the bytes K8 must move over 3.35 TB/s and
the 32-bit and special-function operations of its chain-steps' moves on
the MA(2) program over their peaks (``harness/ma2_ops.py``,
``harness/peaks.py``), for the work the window's jobs did: their
transitions and, from the returned ``global_attempts``, how many took the
iSIR move.  Where the trace holds fewer K8 launches than the jobs ran, the
work is scaled to the launches it holds.  None without a K8 launch."""

from perfbench.harness import ma2_ops

KERNEL = "generic_glmcmc_kernel"


def read(rc):
    spans = rc.timeline.kernels(KERNEL)
    job = rc.job
    g_att = getattr(job, "global_attempts", None)
    if not spans or not g_att:
        return None
    launches = -(-(job.n_ite - 1) // job.T) * len(job.work)
    seen = min(len(spans), launches) / launches
    least, _ = ma2_ops.k8_bound_s(job.pb["num_draws"],
                                  job.smp["batch_size"], job.C, launches,
                                  sum(job.work), sum(g_att))
    busy = sum(e - s for s, e, _ in spans) * 1e-6
    return 100.0 * least * seen / busy
