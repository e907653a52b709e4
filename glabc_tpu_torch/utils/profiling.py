"""Tracing, profiling and debug hooks.

Port of ``glabc_tpu/utils/profiling.py``:

* :func:`annotate` -- a named span around a phase of the program, with the
  bytes it moves (``nbytes``).  With no profiler recording it is an NVTX
  range only (when CUDA is available), for Nsight.  While a
  ``torch.profiler`` records, it is also a ``record_function`` range (on
  the trace's clock) and a record in the process's span store: name,
  enclosing span, ``nbytes``, and a pair of CUDA events on the current
  stream (the host clock where CUDA is not initialised, whose work is
  synchronous).  It never waits for the device;
* :func:`spans` / :func:`reset` -- the finished records, their device
  times read from the events once the device has passed them, and the
  emptying of the store;
* :func:`trace` -- ``torch.profiler.profile`` around a block (the host,
  and the device when CUDA is available, synchronized before the profiler
  stops), written as a Chrome trace into a directory, with the block's
  span records;
* :func:`debug_mode` -- development switches: autograd anomaly detection
  (NaNs raised where they appear in a backward pass) and a float64 default
  dtype, both restored on exit, an exception included.

The program's spans (``glabc.run.*`` around a fused driver's call,
``glabc.io.h2d``/``glabc.io.d2h`` around its host copies, ``glabc.epoch``
and its phases ``glabc.epoch.{anneal,support,redraw,density,pool}``,
``glabc.mesh.gather``/``glabc.mesh.all_sum`` around collectives) are
listed in the README.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import NamedTuple, Optional

import torch

__all__ = ["annotate", "spans", "reset", "SpanRecord", "trace",
           "debug_mode"]


class SpanRecord(NamedTuple):
    """A finished span: ``parent`` is the index in :func:`spans`' list of
    the span it ran inside (None at the top); ``device_ms`` the stream
    time between its entry and exit (idle included), or the host time
    where it recorded no CUDA events; ``host_ms`` the host time."""

    name: str
    parent: Optional[int]
    nbytes: int
    device_ms: float
    host_ms: float


_records = []                 # every recorded span, in order of entry
_stack = threading.local()    # the open recorded spans of each thread
_nvtx = None                  # CUDA available: decided at first use


def _use_nvtx() -> bool:
    global _nvtx
    if _nvtx is None:
        _nvtx = torch.cuda.is_available()
    return _nvtx


class _Span(contextlib.ContextDecorator):
    """One entry of :func:`annotate`; while a profiler records, also the
    record that :func:`spans` reads."""

    __slots__ = ("name", "nbytes", "parent", "t0", "t1", "e0", "e1", "rf")

    def __init__(self, name: str, nbytes: int = 0):
        self.name = name
        self.nbytes = nbytes
        self.rf = None

    def _recreate_cm(self):
        # a decorated function's every call gets a span of its own
        return _Span(self.name, self.nbytes)

    def __enter__(self):
        if _use_nvtx():
            torch.cuda.nvtx.range_push(self.name)
        if torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
            stack = getattr(_stack, "open", None)
            if stack is None:
                stack = _stack.open = []
            self.nbytes = int(self.nbytes)
            self.parent = stack[-1] if stack else None
            self.e0 = self.e1 = self.t1 = None
            _records.append(self)
            stack.append(self)
            if torch.cuda.is_initialized():
                self.e0 = torch.cuda.Event(enable_timing=True)
                self.e0.record()
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rf, self.rf = self.rf, None
        if rf is not None:
            self.t1 = time.perf_counter_ns()
            if self.e0 is not None:
                self.e1 = torch.cuda.Event(enable_timing=True)
                self.e1.record()
            _stack.open.pop()
            rf.__exit__(*exc)
        if _use_nvtx():
            torch.cuda.nvtx.range_pop()
        return False


def annotate(name: str, nbytes: int = 0) -> _Span:
    """Named span: ``with annotate('glabc.io.d2h', x.nbytes): ...``, or
    ``@annotate('name')`` on a function.  ``nbytes``: the bytes the span
    moves (a copy's or a collective's), summed by the readers of
    :func:`spans`."""
    return _Span(name, nbytes)


def spans() -> list:
    """The finished spans recorded since :func:`reset`, as
    :class:`SpanRecord` in order of entry.  Waits for the device to pass
    each span's exit event: call it after the work, never inside it."""
    index, out = {}, []
    for sp in _records:
        if sp.t1 is None:
            continue
        host = (sp.t1 - sp.t0) * 1e-6
        dev = host
        if sp.e1 is not None:
            sp.e1.synchronize()
            dev = sp.e0.elapsed_time(sp.e1)
        index[id(sp)] = len(out)
        parent = None if sp.parent is None else index.get(id(sp.parent))
        out.append(SpanRecord(sp.name, parent, sp.nbytes, float(dev), host))
    return out


def reset() -> None:
    """Empty the span store."""
    _records.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block, host and (where available) CUDA
    activity, and write it on exit as the Chrome trace
    ``<log_dir>/trace_<pid>_<ns>.json`` (open it in Perfetto or
    ``chrome://tracing``).  Yields the ``torch.profiler.profile``, whose
    ``key_averages()``, ``trace_path`` and ``spans`` (the block's
    :func:`spans`; both set on exit) the caller may read.  Empties the
    span store on entry."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    reset()
    try:
        with prof:
            yield prof
            if torch.cuda.is_available():   # the block's kernels finish
                torch.cuda.synchronize()     # inside the trace
    finally:
        prof.spans = spans()
        prof.trace_path = os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def debug_mode(nans: bool = True, x64: bool = False):
    """Development numerics: with ``nans``, autograd anomaly detection
    (a backward pass that makes a NaN raises, naming the forward
    operation); with ``x64``, float64 as the default dtype (else float32).
    Both are restored on exit."""
    prev_nans = torch.is_anomaly_enabled()
    prev_dtype = torch.get_default_dtype()
    torch.set_anomaly_enabled(nans)
    torch.set_default_dtype(torch.float64 if x64 else torch.float32)
    try:
        yield
    finally:
        torch.set_anomaly_enabled(prev_nans)
        torch.set_default_dtype(prev_dtype)
