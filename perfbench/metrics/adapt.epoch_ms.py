"""``adapt.epoch_ms``: device-timeline time between a segment's K5 launch
and the next segment's, summed over the window's jobs and divided by the
number of epochs they ran, in ms.  A job runs ``segments`` K5 launches
with an epoch between two; None when the trace does not hold whole jobs'
launches."""

KERNEL = "pool_isir_mixed"


def read(rc):
    spans = rc.timeline.kernels(KERNEL)
    seg = getattr(rc.job, "segments", 0)
    jobs = len(rc.job.work)
    if seg < 2 or not jobs or len(spans) != seg * jobs:
        return None
    gaps = 0.0
    for j in range(jobs):
        own = spans[j * seg:(j + 1) * seg]
        gaps += sum(b.start - a.end for a, b in zip(own, own[1:]))
    return gaps * 1e-3 / (jobs * (seg - 1))
