"""
Profiling and throughput observability
======================================

The reference has no tracing/profiling beyond wall-clock prints
(SURVEY.md §5).  This module adds:

* :func:`trace` — context manager around ``torch.profiler`` writing a
  TensorBoard/Chrome trace of the host and of every CUDA device;
* :func:`span` — a named host phase of the integrators' kernel path
  (``qgs.state_in``, ``qgs.route``, ``qgs.layout``, ``qgs.layout_in``)
  and of the rank-5 contraction (``qgs.two_level``),
  written into that trace and summed in :func:`span_totals` while a
  profiler runs, one check and nothing else otherwise;
* :class:`ThroughputMeter` — steps/s and mode-updates/s counters (the
  north-star metrics of BASELINE.json).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# span name -> [count, seconds] of the spans closed while a profiler ran
_span_table = {}
_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir=None):
    """Capture a trace of the body: CPU activity always, CUDA activity
    where CUDA is available.  The trace (``*.pt.trace.json``, readable by
    TensorBoard's profiler plugin and by ``chrome://tracing``) is written
    into ``logdir`` (default: ``qgs_tpu_trace`` in the temporary
    directory) when the body ends, also when it raises.  Yields
    ``logdir``."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "qgs_tpu_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()


def span(name):
    """A context manager that marks a host phase ``name`` of the port.

    With no ``torch.profiler`` active it is one shared no-op context,
    after a single check.  Under a profiler (:func:`trace`, or any
    ``torch.profiler.profile``) the body runs inside a host operation
    named ``name`` of the profiler's trace, on the clock of the device's
    kernels and copies, and the span's count and ``time.perf_counter``
    seconds are added to :func:`span_totals`.

    The operation is recorded as an ordinary host operation
    (``torch._C._profiler._RecordFunctionFast``), not as a
    ``record_function`` user annotation: the profiler mirrors an
    annotation onto the device's timeline over the copies it launches,
    where a reader of the device's work would take it for an operation.
    Spans are leaf phases of one call and are not nested, so a span's
    duration is its own time."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _recorded(name)


@contextlib.contextmanager
def _recorded(name):
    with torch._C._profiler._RecordFunctionFast(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            entry = _span_table.setdefault(name, [0, 0.0])
            entry[0] += 1
            entry[1] += time.perf_counter() - t0


def span_totals():
    """``{name: (count, seconds)}`` of the spans closed under a profiler
    since the process started or :func:`reset_spans`."""
    return {name: (count, seconds)
            for name, (count, seconds) in _span_table.items()}


def reset_spans():
    """Clear :func:`span_totals`."""
    _span_table.clear()


class ThroughputMeter:
    """Accumulate integration-throughput statistics.

    ``mode-updates/s`` counts (ensemble x steps x ndim) state-component
    updates per second — the resolution-independent throughput metric.
    Where CUDA is initialised, leaving the ``with`` body synchronises the
    current device first, so that the time is the device's work and not
    only its launches.
    """

    def __init__(self, ndim, ensemble=1):
        self.ndim = ndim
        self.ensemble = ensemble
        self.steps = 0
        self.elapsed = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():     # the device's time, not the
            torch.cuda.synchronize()        # launches'
        self.elapsed += time.perf_counter() - self._t0
        self._t0 = None
        return False

    def add_steps(self, n):
        self.steps += n

    @property
    def steps_per_s(self):
        return self.steps / self.elapsed if self.elapsed else 0.0

    @property
    def traj_steps_per_s(self):
        return self.steps_per_s * self.ensemble

    @property
    def mode_updates_per_s(self):
        return self.traj_steps_per_s * self.ndim

    def report(self):
        return {
            "steps_per_s": self.steps_per_s,
            "traj_steps_per_s": self.traj_steps_per_s,
            "mode_updates_per_s": self.mode_updates_per_s,
            "ensemble": self.ensemble,
            "ndim": self.ndim,
        }
