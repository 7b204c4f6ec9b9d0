"""The port's ``utils/profiling`` and ``plotting/util`` against the JAX
package's: ``ThroughputMeter`` reports the same numbers for the same steps
and elapsed time, and synchronises the card where CUDA is initialised;
``trace`` writes a ``torch.profiler`` trace into its ``logdir`` (on the CPU
here), yields it, and stops the profiler when the body raises; ``span`` is
one shared no-op without a profiler, and under ``trace`` a host operation
of the written trace counted in ``span_totals``; ``group_layout`` counts
its builds; ``std_plot`` draws tensors."""

import json
import pathlib

import numpy as np
import pytest
import torch

from qgs_tpu.plotting.util import std_plot as jax_std_plot
from qgs_tpu.utils.profiling import ThroughputMeter as JaxThroughputMeter
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.ops import fused_rk4
from qgs_tpu_torch.ops.contraction import from_numpy
from qgs_tpu_torch.plotting.util import std_plot, to_host
from qgs_tpu_torch.utils import profiling
from qgs_tpu_torch.utils.profiling import ThroughputMeter, trace

# MAOOAM's 36-variable tensor as the benchmark froze it
MAOOAM36 = (pathlib.Path(__file__).resolve().parents[1] / "portbench"
            / "reference" / "tensors" / "maooam36.npz")


@pytest.mark.parametrize("ndim, ensemble, steps, elapsed",
                         [(36, 4096, 10_000, 0.0789), (20, 1, 7, 2.5),
                          (38, 16, 0, 0.0)])
def test_throughput_meter_reports_as_jax(ndim, ensemble, steps, elapsed):
    meters = [JaxThroughputMeter(ndim, ensemble), ThroughputMeter(ndim,
                                                                  ensemble)]
    for m in meters:
        m.add_steps(steps)
        m.elapsed = elapsed
    assert meters[1].report() == meters[0].report()


def test_throughput_meter_times_its_body():
    m = ThroughputMeter(36, ensemble=8)
    with m as inside:
        assert inside is m
        m.add_steps(100)
    assert m.elapsed > 0 and m._t0 is None
    assert m.traj_steps_per_s == pytest.approx(800 / m.elapsed)
    assert m.mode_updates_per_s == pytest.approx(36 * 800 / m.elapsed)


def test_throughput_meter_times_its_body_as_jax(monkeypatch):
    """Timed by ``with`` where CUDA is not initialised, the meter reports
    what the JAX package's meter reports for the same steps and elapsed
    time, and does not touch CUDA."""
    def refused(device=None):
        raise AssertionError("synchronised without CUDA")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize", refused)
    m = ThroughputMeter(36, ensemble=16)
    with m:
        m.add_steps(50)
    with m:
        m.add_steps(25)
    ref = JaxThroughputMeter(36, 16)
    ref.add_steps(75)
    ref.elapsed = m.elapsed
    assert m.report() == ref.report()


def test_throughput_meter_synchronises_cuda(monkeypatch):
    """Where CUDA is initialised, leaving the body synchronises the
    current device before the clock is read."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    m = ThroughputMeter(36)
    with m:
        assert calls == []
    assert calls == [None] and m.elapsed > 0


def trace_events(logdir):
    files = sorted(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    return json.loads(files[0].read_text())["traceEvents"]


def test_trace_writes_into_logdir(tmp_path):
    logdir = tmp_path / "trace"
    with trace(str(logdir)) as out:
        assert out == str(logdir)
        assert torch.autograd.profiler._is_profiler_enabled
        x = torch.ones(64, 64, dtype=torch.float64)
        (x @ x).sum()
    names = {e.get("name") for e in trace_events(logdir)}
    assert "aten::mm" in names


def test_trace_stops_when_the_body_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with trace(str(tmp_path)):
            torch.ones(3).sum()
            1 / 0
    assert trace_events(tmp_path)
    assert not torch.autograd.profiler._is_profiler_enabled
    with trace(str(tmp_path / "again")):       # a second trace can start
        torch.ones(3).sum()
    assert trace_events(tmp_path / "again")


@pytest.fixture
def no_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def test_span_without_a_profiler_is_one_shared_no_op(no_spans, monkeypatch):
    """With no profiler, a span is the shared no-op context: it opens no
    record function and records nothing."""
    def refused(*args):
        raise AssertionError("a record function was opened")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not torch.autograd.profiler._is_profiler_enabled
    ctx = profiling.span("qgs.layout")
    assert ctx is profiling.span("qgs.state_in") is profiling._NO_SPAN
    with ctx:
        torch.ones(3).sum()
    assert profiling.span_totals() == {}


def test_span_under_trace(tmp_path, no_spans):
    """Under ``trace``, a span is a host operation of the written trace
    (not a user annotation, which the profiler mirrors onto the device's
    timeline) and counts once in ``span_totals``; ``reset_spans``
    clears the table."""
    with trace(str(tmp_path)):
        with profiling.span("qgs.test_span"):
            torch.ones(64, 64).sum()
    spans = [e for e in trace_events(tmp_path)
             if e.get("name") == "qgs.test_span"]
    assert len(spans) == 1 and spans[0]["cat"] == "cpu_op"
    count, seconds = profiling.span_totals()["qgs.test_span"]
    assert count == 1 and 0 < seconds <= spans[0]["dur"] * 1e-6
    profiling.reset_spans()
    assert profiling.span_totals() == {}


def maooam36(device="cpu"):
    with np.load(MAOOAM36) as npz:
        return from_numpy(npz["coords"], npz["data"], tuple(npz["shape"]),
                          torch.float64, device)


def test_traced_integrate_records_the_state_upload(tmp_path, no_spans):
    """A CPU ``RungeKuttaIntegrator.integrate`` from a NumPy state records
    ``qgs.state_in`` once; the CPU takes no fused kernel, so the route
    and layout spans stay out."""
    integrator = RungeKuttaIntegrator()
    integrator.set_func(maooam36())
    ic = np.random.default_rng(5).random((4, 36)) * 0.01
    with trace(str(tmp_path)):
        integrator.integrate(0., 1., 0.1, ic=ic, write_steps=5)
    totals = profiling.span_totals()
    assert set(totals) == {"qgs.state_in"} and totals["qgs.state_in"][0] == 1
    assert "qgs.state_in" in {e.get("name") for e in trace_events(tmp_path)}


def test_group_layout_counts_its_builds():
    """``group_layout`` on the frozen MAOOAM tensor raises
    ``layout_builds`` by exactly 1; ``row_groups`` alone builds none."""
    f = maooam36()
    before = fused_rk4.layout_builds
    fused_rk4.row_groups(f.coords, f.shape[0], fused_rk4.K1.groups)
    assert fused_rk4.layout_builds == before
    fused_rk4.group_layout(f.coords, f.data, f.shape, fused_rk4.K1.groups)
    assert fused_rk4.layout_builds == before + 1


def test_std_plot_draws_tensors():
    """``std_plot`` takes tensors and draws what the JAX package's draws
    from the same arrays."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    x = np.linspace(0., 1., 11)
    mean, std = np.sin(x), 0.1 + 0 * x
    ax = std_plot(torch.as_tensor(x), torch.as_tensor(mean),
                  torch.as_tensor(std), color="C1")
    ref = jax_std_plot(x, mean, std, color="C1")
    np.testing.assert_array_equal(ax.lines[0].get_xydata(),
                                  ref.lines[0].get_xydata())
    band = [a.collections[0].get_paths()[0].vertices for a in (ax, ref)]
    np.testing.assert_array_equal(*band)
    assert to_host(torch.ones(2)).dtype == np.float32
    plt.close("all")
