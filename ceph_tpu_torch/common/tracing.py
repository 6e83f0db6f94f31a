"""Tracing/profiling helpers (LTTng-tracepoint / Jaeger-span analog).

The reference compiles in LTTng tracepoints and optional OpenTelemetry
spans (``src/tracing/*.tp``, ``src/common/tracer.cc``).  Here:

- :func:`trace_annotation` — a named span in ``torch.profiler`` traces
  (``record_function``), around host-side stages and device launches;
- :func:`profile_to` — profile a block (CPU and, with a card, CUDA
  activity) and export a Chrome/Perfetto trace into a directory;
- :func:`timed_block` — lightweight wall-clock span feeding a
  perf-counter time_avg, for always-on op accounting.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named span in profiler timelines (cheap when not profiling)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Profile the block and write ``<log_dir>/trace.json`` (open it in
    Perfetto or chrome://tracing); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def timed_block(perf_counters, counter: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        perf_counters.tinc(counter, time.perf_counter() - t0)
