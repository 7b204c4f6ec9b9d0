"""The port's ``utils/profiling`` and ``plotting/util`` against the JAX
package's: ``ThroughputMeter`` reports the same numbers for the same steps
and elapsed time; ``trace`` writes a ``torch.profiler`` trace into its
``logdir`` (on the CPU here), yields it, and stops the profiler when the
body raises; ``std_plot`` draws tensors."""

import json

import numpy as np
import pytest
import torch

from qgs_tpu.plotting.util import std_plot as jax_std_plot
from qgs_tpu.utils.profiling import ThroughputMeter as JaxThroughputMeter
from qgs_tpu_torch.plotting.util import std_plot, to_host
from qgs_tpu_torch.utils.profiling import ThroughputMeter, trace


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
