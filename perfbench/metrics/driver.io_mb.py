"""``driver.io_mb``: the bytes of the program's host copies (the
``nbytes`` of its ``glabc.io.h2d`` and ``glabc.io.d2h`` spans) over the
window's jobs, over the number of fused-driver calls (``glabc.run.*``
spans), in MB (1e6 bytes); None without them."""

from perfbench.harness.spans import per, records


def read(rc):
    v = per(records(), "glabc.io.", "nbytes", "glabc.run.")
    return None if v is None else v * 1e-6
