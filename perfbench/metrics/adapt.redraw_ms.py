"""``adapt.redraw_ms``: the stream time of the program's
``glabc.epoch.redraw`` spans (each redraw chunk's KDE draws, prior check
and stable partition) over the window's jobs, over the number of
``glabc.epoch`` spans, in ms; None without them."""

from perfbench.harness.spans import epoch_ms


def read(rc):
    return epoch_ms("redraw")
