"""The readers of the port's spans and layout counter, on a fake readings
object: the spans' sums a call, the builds a launch, the idle share named
after a span, and None without a trace, without a traced launch, or on a
port that has no spans."""

from types import SimpleNamespace

import pytest

from portbench.harness import loader
from portbench.tests.conftest import run_cpu, shrink

TOTALS = {"qgs.state_in": (200, 0.004), "qgs.route": (100, 0.010),
          "qgs.layout": (100, 0.030), "qgs.layout_in": (100, 0.020)}
GAPS = [[0.003, "qgs.layout"], [0.002, "aten::to"], [0.001, "qgs.route"],
        [0.002, "(python, between ops)"], [0.002, "qgs.state_in"]]


@pytest.fixture
def port(monkeypatch):
    """The port's span table and K1 counters as a traced run of 100
    launches after one warm-up leaves them."""
    from qgs_tpu_torch.ops import fused_rk4
    from qgs_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "span_totals", lambda: dict(TOTALS))
    monkeypatch.setattr(fused_rk4, "launches", 100)
    monkeypatch.setattr(fused_rk4, "launches_streamed", 1)
    monkeypatch.setattr(fused_rk4, "layout_builds", 101)
    return profiling


def readings(calls=100, traced=True):
    trace = ({"window_s": 0.2, "busy_s": 0.08, "device_events": 1000,
              "ops": {}, "gaps": GAPS} if traced else None)
    return SimpleNamespace(trace=trace, calls=calls)


def read(name, r):
    return loader.metric(name).read(r)


def test_units():
    assert {name: loader.metric(name).UNIT for name in (
        "layout_ms.ens", "layout_ms.da", "state_in_ms.da",
        "layout_builds_per_launch.da", "idle_in_spans.da")} == {
        "layout_ms.ens": "ms", "layout_ms.da": "ms", "state_in_ms.da": "ms",
        "layout_builds_per_launch.da": "builds/launch",
        "idle_in_spans.da": "%"}


def test_sums_and_ratios(port):
    r = readings()
    assert read("layout_ms.ens", r) == pytest.approx(0.6)   # 60 ms / 100
    assert read("layout_ms.da", r) == pytest.approx(0.6)
    assert read("state_in_ms.da", r) == pytest.approx(0.04)
    assert read("layout_builds_per_launch.da", r) == pytest.approx(1.0)
    assert read("idle_in_spans.da", r) == pytest.approx(60.0)  # 6 of 10 ms


@pytest.mark.parametrize("name", ["layout_ms.ens", "layout_ms.da",
                                  "state_in_ms.da",
                                  "layout_builds_per_launch.da",
                                  "idle_in_spans.da"])
def test_none_without_a_trace_or_a_launch(port, monkeypatch, name):
    assert read(name, readings(traced=False)) is None
    monkeypatch.setattr(port, "span_totals",
                        lambda: {"qgs.state_in": (2, 0.001)})
    assert read(name, readings()) is None           # no launch traced


@pytest.mark.parametrize("name", ["layout_ms.ens", "layout_ms.da",
                                  "state_in_ms.da",
                                  "layout_builds_per_launch.da",
                                  "idle_in_spans.da"])
def test_none_on_a_port_without_spans(port, monkeypatch, name):
    """A port older than the spans (no ``span_totals``, no
    ``layout_builds``) reads nothing, and nothing raises."""
    from qgs_tpu_torch.ops import fused_rk4
    monkeypatch.delattr(port, "span_totals")
    monkeypatch.delattr(fused_rk4, "layout_builds")
    assert read(name, readings()) is None


def test_idle_in_spans_without_idle(port):
    r = readings()
    r.trace["gaps"] = []
    assert read("idle_in_spans.da", r) is None


def test_builds_without_launches(port, monkeypatch):
    from qgs_tpu_torch.ops import fused_rk4
    monkeypatch.setattr(fused_rk4, "launches", 0)
    monkeypatch.setattr(fused_rk4, "launches_streamed", 0)
    assert read("layout_builds_per_launch.da", readings()) is None


def test_a_traced_cpu_run_reads_nothing():
    """On the CPU no kernel launches, so the readers find no traced launch
    (the run still records ``qgs.state_in``)."""
    from qgs_tpu_torch.utils import profiling

    def wire(cell):
        shrink(cell)
        cell["workload"]["per_layer"] += ["layout_ms.da", "state_in_ms.da",
                                          "layout_builds_per_launch.da",
                                          "idle_in_spans.da"]

    profiling.reset_spans()
    result = run_cpu("maooam36.da-f64", trace=True, edit=wire)
    assert profiling.span_totals()["qgs.state_in"][0] >= 3
    profiling.reset_spans()
    assert not {"layout_ms.da", "state_in_ms.da",
                "layout_builds_per_launch.da",
                "idle_in_spans.da"} & set(result["metrics"])
    assert result["correct"] is True
