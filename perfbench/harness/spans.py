"""The program's own spans of a traced window, for the per-layer metrics'
readers.

While a profiler records, ``glabc_tpu_torch.utils.profiling.annotate``
keeps a record of each span the program opens (name, enclosing span,
bytes moved, stream time between two CUDA events); the harness's profiler
covers the window alone, so the store holds the window's spans.
:func:`records` reads them; a program without that store gives none, and
the readers return None.
"""

from __future__ import annotations


def records() -> list:
    """The window's span records (``SpanRecord``), or ``[]``."""
    try:
        from glabc_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def named(recs: list, name: str) -> list:
    """The records called ``name`` or, for ``name`` ending in a dot, every
    record whose name starts with it."""
    if name.endswith("."):
        return [r for r in recs if r.name.startswith(name)]
    return [r for r in recs if r.name == name]


def per(recs: list, name: str, field: str, per_name: str):
    """The sum of ``field`` over the records ``name`` over the number of
    records ``per_name``; None when either is absent."""
    num = named(recs, name)
    den = len(named(recs, per_name))
    if not num or not den:
        return None
    return sum(getattr(r, field) for r in num) / den


def epoch_ms(*phases: str):
    """The stream time of the epoch's ``phases`` (``glabc.epoch.<phase>``
    spans) summed, over the number of epochs, in ms; None without an
    epoch or without one of the phases."""
    recs = records()
    parts = [per(recs, f"glabc.epoch.{p}", "device_ms", "glabc.epoch")
             for p in phases]
    return None if None in parts else sum(parts)
