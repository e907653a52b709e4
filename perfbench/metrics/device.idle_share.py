"""``device.idle_share``: the share of the traced window (rank 0's on
several chips) in which no kernel, copy or set runs on the device, in %."""


def read(rc):
    t = rc.timeline
    if not t.busy:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
