"""``adapt.select_ms``: the stream time of the program's
``glabc.epoch.anneal`` (the threshold's quantile) and
``glabc.epoch.support`` spans (training weights, systematic resample,
support join, KDE fit) over the window's jobs, over the number of
``glabc.epoch`` spans, in ms; None without them."""

from perfbench.harness.spans import epoch_ms


def read(rc):
    return epoch_ms("anneal", "support")
