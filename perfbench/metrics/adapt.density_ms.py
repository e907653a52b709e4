"""``adapt.density_ms``: the stream time of the program's
``glabc.epoch.density`` spans (each redraw chunk's KDE density of its new
pool rows, between two CUDA events) over the window's jobs, over the
number of ``glabc.epoch`` spans, in ms; None without them."""

from perfbench.harness.spans import epoch_ms


def read(rc):
    return epoch_ms("density")
