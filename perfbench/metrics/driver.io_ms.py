"""``driver.io_ms``: the stream time of the program's host copies
(``glabc.io.h2d`` and ``glabc.io.d2h`` spans, between two CUDA events)
over the window's jobs, over the number of fused-driver calls
(``glabc.run.*`` spans), in ms; None without them."""

from perfbench.harness.spans import per, records


def read(rc):
    return per(records(), "glabc.io.", "device_ms", "glabc.run.")
