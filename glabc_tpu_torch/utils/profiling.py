"""Tracing, profiling and debug hooks.

Port of ``glabc_tpu/utils/profiling.py``:

* :func:`annotate` -- a named scope around a sampler phase
  (propose/simulate/weigh/resample/refit): a ``torch.profiler``
  ``record_function`` range, and an NVTX range when CUDA is available, so
  that it shows in a ``torch.profiler`` trace and in an NVTX timeline;
* :func:`trace` -- ``torch.profiler.profile`` around a block (the host,
  and the device when CUDA is available, synchronized before the profiler
  stops), written as a Chrome trace into a directory;
* :func:`debug_mode` -- development switches: autograd anomaly detection
  (NaNs raised where they appear in a backward pass) and a float64 default
  dtype, both restored on exit, an exception included.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["annotate", "trace", "debug_mode"]


@contextlib.contextmanager
def annotate(name: str):
    """Named profiler scope: ``with annotate('simulate'): ...`` (or as a
    decorator)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block, host and (where available) CUDA
    activity, and write it on exit as the Chrome trace
    ``<log_dir>/trace_<pid>_<ns>.json`` (open it in Perfetto or
    ``chrome://tracing``).  Yields the ``torch.profiler.profile``, whose
    ``key_averages()`` and ``trace_path`` (set on exit) the caller may
    read."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            yield prof
            if torch.cuda.is_available():   # the block's kernels finish
                torch.cuda.synchronize()     # inside the trace
    finally:
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
