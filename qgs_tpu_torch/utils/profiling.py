"""
Profiling and throughput observability
======================================

The reference has no tracing/profiling beyond wall-clock prints
(SURVEY.md §5).  This module adds:

* :func:`trace` — context manager around ``torch.profiler`` writing a
  TensorBoard/Chrome trace of the host and of every CUDA device;
* :class:`ThroughputMeter` — steps/s and mode-updates/s counters (the
  north-star metrics of BASELINE.json).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


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


class ThroughputMeter:
    """Accumulate integration-throughput statistics.

    ``mode-updates/s`` counts (ensemble x steps x ndim) state-component
    updates per second — the resolution-independent throughput metric.
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
