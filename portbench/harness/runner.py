"""One run of one cell: set-up, warm-up, the measured (or traced) window,
the comparison with the plain reference, and the result line.

The run's parts, in order:

1. set-up: the kernel library built or loaded (``setup.library_s``), the
   configuration's parameters and ``create_tendencies`` (``setup.tendencies_s``),
   the job's inputs from the seed, and one warm-up call at the cell's
   shapes; ``setup_s`` runs from the process's start to the end of it;
2. the window: calls one after another, each started when the one before
   has returned and its result is on hand (a closed loop), until
   ``seconds`` have passed; with ``trace`` the cell's ``trace_calls``
   calls under the profiler instead;
3. the device's peak memory, then the comparison: the tensor the port's
   set-up built against the frozen reference tensor, and a sample of the
   window's calls drawn from the seed against the plain reference, after
   the window, each number beside its limit; the kernels each call
   launched against the cell's.
"""

from __future__ import annotations

import math
import platform
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

from portbench.harness import checks, loader, trace as tracing
from portbench.reference import qg

# the port's kernel-launch counters, read around every call:
# name -> (module, attribute)
COUNTERS = {
    "k1_resident": ("qgs_tpu_torch.ops.fused_rk4", "launches"),
    "k1_streamed": ("qgs_tpu_torch.ops.fused_rk4", "launches_streamed"),
    "k2_resident": ("qgs_tpu_torch.ops.fused_df_rk4", "launches"),
    "k2_streamed": ("qgs_tpu_torch.ops.fused_df_rk4", "launches_streamed"),
}


def seed_rng(seed, stream):
    """A NumPy generator for one use (``stream``) of the run's seed; any
    whole number, negative or past 64 bits, is a seed."""
    return np.random.default_rng([seed % (1 << 64), stream])


def _counts():
    return {name: getattr(sys.modules[mod], attr)
            for name, (mod, attr) in COUNTERS.items()}


def _delta(before, after):
    return {k: after[k] - before[k] for k in before}


def device_lines(torch):
    """Lines that name the card, its power limit and the versions."""
    lines = [f"python {platform.python_version()}, torch {torch.__version__},"
             f" CUDA {torch.version.cuda}"]
    if torch.cuda.is_available():
        lines.append(f"device {torch.cuda.get_device_name(0)} x "
                     f"{torch.cuda.device_count()}")
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30)
            lines += [f"nvidia-smi: {ln}" for ln in smi.stdout.splitlines()]
        except (OSError, subprocess.TimeoutExpired) as err:
            lines.append(f"nvidia-smi: not read ({err})")
    return lines


class Context(SimpleNamespace):
    """What a job is given: the cell's files, the seed, the device, the
    port's tendencies, and the frozen reference tensor."""

    def sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)


def run(cell_name, seed, seconds, trace, *, t_start, marks=None,
        device="cuda", root=None, edit=None, edit_job=None, say=print):
    """Run the cell once; returns the result line's dict.  ``t_start`` is
    the process's start on ``time.perf_counter``'s clock, ``marks`` the
    seconds of its parts before this call (printed); ``edit(cell)`` may
    change the loaded cell's dicts before the run (the tests shrink the
    traffic with it), and ``edit_job(job, ctx)`` the job before its
    warm-up (the control and the tests put another computation in the
    program's place with it); ``say`` prints the lines before the
    last."""
    import torch

    from qgs_tpu_torch.models.tendencies import create_tendencies
    from qgs_tpu_torch.ops import _build
    from qgs_tpu_torch.params.params import QgParams
    from portbench.harness.qgconfig import build_params

    cell = loader.cell(cell_name, root)
    if edit is not None:
        edit(cell)
    wl, cfg, tr = cell["workload"], cell["config"], cell["traffic"]
    device = torch.device(device)

    timers = dict(marks or {})
    timers["imports_s"] = (time.perf_counter() - t_start
                           - sum(timers.values()))
    t = time.perf_counter()
    if device.type == "cuda":
        _build.load_library()
    timers["library_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pars = build_params(QgParams, cfg["qgparams"])
    f, Df, qgt = create_tendencies(pars, return_qgtensor=True,
                                   device=device)
    timers["tendencies_s"] = time.perf_counter() - t

    t = time.perf_counter()
    ctx = Context(cell=cell, config=cfg, params=tr["params"], seed=seed,
                  device=device, f=f, Df=Df, qgt=qgt,
                  frozen=qg.load_tensor(cfg), rng=lambda s: seed_rng(seed, s),
                  tensor=(qgt.tensor.coords, qgt.tensor.data))
    job = cell["job"].Job(ctx)
    if edit_job is not None:
        edit_job(job, ctx)
    timers["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    job.call(0)                            # the warm-up, at the cell's shapes
    timers["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    say(f"set-up {setup_s:.3f} s: "
        + ", ".join(f"{k[:-2]} {v:.3f} s" for k, v in timers.items()))

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sample = checks.Reservoir(wl["check"]["calls"], seed_rng(seed, 99))
    paths, call_s = [], []

    def one(i):
        before, t = _counts(), time.perf_counter()
        key, out = job.call(i)
        call_s.append(time.perf_counter() - t)
        paths.append(_delta(before, _counts()))
        sample.offer((key, out))

    summary = None
    if trace:
        n_calls = wl["trace_calls"]
        _, events = tracing.profile(
            lambda: [one(i) for i in range(1, n_calls + 1)])
        summary = tracing.trace_summary(events)
        say(f"trace: {len(events)} events, "
            f"{summary['device_events'] if summary else 0} on the device")
        window_s = summary["window_s"] if summary else math.nan
    else:
        n_calls, start = 0, time.perf_counter()
        while True:
            n_calls += 1
            one(n_calls)
            window_s = time.perf_counter() - start
            if window_s >= seconds:
                break
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    for line in device_lines(torch):
        say(line)
    expect = wl["expect_launches"]
    wrong = sum(1 for p in paths if p != expect)
    kinds = sorted({tuple(sorted(p.items())) for p in paths})
    say(f"window: {n_calls} calls in {window_s:.6f} s; kernels a call: "
        + "; ".join(", ".join(f"{k} {v}" for k, v in kind)
                    for kind in kinds)
        + f" (the cell's: {', '.join(f'{k} {v}' for k, v in expect.items())}"
        f"); calls on another path {wrong}; a call's seconds: "
        + ", ".join(f"{q} {v:.6f}" for q, v in zip(
            ("least", "median", "p95", "most"),
            np.quantile(call_s, [0, 0.5, 0.95, 1]))))

    readings = SimpleNamespace(setup_s=setup_s, timers=timers,
                               window_s=window_s, calls=n_calls,
                               units=n_calls * job.units_per_call,
                               trace=summary, job=job, workload=wl)
    names = wl["per_layer"] if trace else wl["end_to_end"]
    metrics = {}
    for name in names:
        reader = loader.metric(name, root)
        value = reader.read(readings)
        if value is not None:
            metrics[name] = {"value": value, "unit": reader.UNIT}

    t = time.perf_counter()
    compared = sample.items() + getattr(job, "compared_always", [])
    numbers = compare(job, ctx.tensor, ctx.frozen, compared)
    say(f"compared {len(compared)} calls with the reference in "
        f"{time.perf_counter() - t:.3f} s")
    numbers["path_faults"] = wrong
    limits = wl["check"]["limits"]
    checked = {name: {"value": numbers[name], "limit": limits[name]}
               for name in limits}
    correct = all(c["value"] <= c["limit"] for c in checked.values())
    for name, c in checked.items():
        print(f"check {name} {c['value']!r} <= {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr, flush=True)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else platform.processor()),
           "count": (torch.cuda.device_count() if device.type == "cuda"
                     else 1), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": n_calls, "failed": wrong,
              "metrics": metrics, "device": dev}
    if trace and summary:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = tracing.breakdown(summary)
    result["checks"] = checked
    return result


def compare(job, tensor, frozen, sample):
    """The numbers compared: the gap of the set-up's tensor (``(coords,
    data)``) from the frozen one, and each of the job's numbers, the
    widest over the sampled ``(key, output)`` calls."""
    import torch

    numbers = {"tensor_gap": checks.tensor_gap(*tensor, frozen.coords,
                                               frozen.data)}
    refs = job.reference([key for key, _ in sample], torch.float64)
    for (_, out), ref in zip(sample, refs):
        for name, value in job.compare(out, ref).items():
            numbers[name] = max(numbers.get(name, 0.0), value)
    return numbers
