"""``device.idle_in_driver_share``: the share of the traced window (rank
0's on several chips) in which the device is idle while the host is
inside a fused driver's call (a ``glabc.run.*`` range of the program on
the profiler's host timeline), in %; None without such a range."""

from perfbench.harness.trace import merged


def read(rc):
    t = rc.timeline
    runs = merged(sp for sp in t.host if sp.name.startswith("glabc.run."))
    if not runs:
        return None
    idle, i = 0.0, 0
    for s, e in t.gaps():
        while i < len(runs) and runs[i][1] <= s:
            i += 1
        j = i
        while j < len(runs) and runs[j][0] < e:
            idle += max(0.0, min(e, runs[j][1]) - max(s, runs[j][0]))
            j += 1
    return 100.0 * idle * 1e-6 / t.window_s
