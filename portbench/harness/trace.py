"""The device trace of the traced calls, and its summary.

:func:`profile` runs a function under ``torch.profiler`` (host and CUDA
activity) and returns the trace's complete events as Chrome-trace dicts
(``name``, ``cat``, ``ts`` and ``dur`` in microseconds), read from the
profiler in memory: nothing is written to disk.  :func:`trace_summary` is
the port's smoke script's ``trace_summary`` (``chip_smoke.py``), copied so
that the yardstick stays fixed, taking the events instead of a trace file:
the window, the device's busy time (the union of its operations), the time
and count of each device operation, and the idle gaps with the host
operation that overlaps each most."""

from __future__ import annotations

import heapq

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")
NAME_CHARS = 160          # a name in the breakdown is cut to this length


def _category(event):
    """An event's Chrome-trace category, from its device and name (the
    profiler's ``activity_type`` is missing from some torch versions)."""
    name = event.name()
    if "CUDA" in str(event.device_type()):
        return ("gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset"
                if name.startswith("Memset") else "kernel")
    return "cuda_runtime" if name.startswith("cuda") else "cpu_op"


def profile(fn):
    """Run ``fn()`` under the profiler; returns ``(fn's result, events)``."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        result = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    events = [{"name": e.name(), "cat": _category(e),
               "ts": e.start_ns() / 1e3, "dur": e.duration_ns() / 1e3}
              for e in prof.profiler.kineto_results.events()]
    return result, events


def trace_summary(events):
    """``window_s`` (first event's start to last event's end), ``busy_s``
    (the union of the device operations), ``device_events``, ``ops``
    (name -> [seconds, count], each device operation) and ``gaps`` (each
    idle stretch of the device inside the window as ``[seconds, host op
    that overlaps it most]``, longest first)."""
    events = [e for e in events if e["dur"] >= 0]
    if not events:
        return None
    device = sorted((e for e in events if e["cat"] in DEVICE_CATS),
                    key=lambda e: e["ts"])
    host = [e for e in events if e["cat"] in HOST_CATS]
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    spans = []
    for e in device:                    # the union of the device intervals
        a, b = e["ts"], e["ts"] + e["dur"]
        if spans and a <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], b)
        else:
            spans.append([a, b])
    busy = sum(b - a for a, b in spans)
    edges = [start] + [x for s in spans for x in s] + [end]

    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(([(g1 - g0) / 1e6, name]
                   for (g0, g1), name in zip(idle, _host_in(idle, host))),
                  key=lambda g: -g[0])
    ops = {}
    for e in device:
        entry = ops.setdefault(e["name"], [0.0, 0])
        entry[0] += e["dur"] / 1e6
        entry[1] += 1
    return {"window_s": (end - start) / 1e6, "busy_s": busy / 1e6,
            "device_events": len(device), "ops": ops, "gaps": gaps}


def _host_in(gaps, host):
    """For each of the time-ordered, disjoint ``gaps``, the name of the host
    operation that overlaps it most (of equal overlaps an ATen operation
    before a runtime call, then the outermost), by one sweep over the host
    operations; a gap that no host operation overlaps is time in Python
    between operations."""
    host = sorted(host, key=lambda e: e["ts"])
    active, nxt, names = [], 0, []
    for g0, g1 in gaps:
        while nxt < len(host) and host[nxt]["ts"] < g1:
            e = host[nxt]
            heapq.heappush(active, (e["ts"] + e["dur"], nxt))
            nxt += 1
        while active and active[0][0] <= g0:
            heapq.heappop(active)
        best = None
        for end, idx in active:
            overlap = min(end, g1) - max(host[idx]["ts"], g0)
            key = (overlap, host[idx]["cat"] == "cpu_op", host[idx]["dur"])
            if overlap > 0 and (best is None or key > best[0]):
                best = (key, host[idx]["name"])
        names.append(best[1] if best else "(python, between ops)")
    return names


def device_seconds(summary, fragment):
    """Seconds of the device operations whose name holds ``fragment``."""
    return sum(s for name, (s, _) in summary["ops"].items()
               if fragment in name)


def breakdown(summary, top=10):
    """The ``breakdown`` of the result line: the ``top`` device operations
    by time, and the idle gaps summed by the host operation in them, the
    ``top`` longest."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])[:top]
    by_host = {}
    for seconds, name in summary["gaps"]:
        by_host[name] = by_host.get(name, 0.0) + seconds
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:NAME_CHARS], s] for name, (s, _) in ops],
            "idle_gaps": [[name[:NAME_CHARS], s] for name, s in gaps]}
