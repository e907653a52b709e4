"""``adapt.pool_ms``: the stream time of the program's
``glabc.epoch.pool`` spans (each redraw chunk's simulation and weights of
its new pool rows, and the driver's repack of the pools and the resident
KDE after the epoch) over the window's jobs, over the number of
``glabc.epoch`` spans, in ms; None without them."""

from perfbench.harness.spans import epoch_ms


def read(rc):
    return epoch_ms("pool")
