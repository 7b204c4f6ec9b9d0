"""The trace reader on a small recorded trace whose numbers are known:
the window, the device's busy union (an annotation is no device work),
each operation's time and count, and the idle gaps by host operation."""

import json
import pathlib

import pytest

from portbench.harness import trace as tracing

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "trace_small.json"


@pytest.fixture
def summary():
    with open(FIXTURE) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    return tracing.trace_summary(events)


def test_window_and_busy(summary):
    assert summary["window_s"] == pytest.approx(540e-6)
    assert summary["busy_s"] == pytest.approx(330e-6)     # [120, 350], [400, 500]
    assert summary["device_events"] == 3


def test_operations(summary):
    assert summary["ops"] == {"k1": [pytest.approx(300e-6), 2],
                              "Memcpy HtoD": [pytest.approx(50e-6), 1]}
    assert tracing.device_seconds(summary, "k1") == pytest.approx(300e-6)


def test_gaps_by_host_op(summary):
    assert [g[1] for g in summary["gaps"]] == ["aten::to", "outer", "outer"]
    assert [g[0] for g in summary["gaps"]] == pytest.approx(
        [120e-6, 50e-6, 40e-6])


def test_breakdown(summary):
    b = tracing.breakdown(summary)
    assert b["device_ops"] == [["k1", pytest.approx(300e-6)],
                               ["Memcpy HtoD", pytest.approx(50e-6)]]
    assert b["idle_gaps"] == [["aten::to", pytest.approx(120e-6)],
                              ["outer", pytest.approx(90e-6)]]


def test_a_gap_no_host_op_covers():
    events = [{"name": "k", "cat": "kernel", "ts": 0, "dur": 10},
              {"name": "k", "cat": "kernel", "ts": 30, "dur": 10}]
    s = tracing.trace_summary(events)
    assert s["gaps"] == [[pytest.approx(20e-6), "(python, between ops)"]]


def test_no_events():
    assert tracing.trace_summary([]) is None


def test_profile_on_the_cpu():
    import torch
    x = torch.ones(64, 64)
    result, events = tracing.profile(lambda: (x @ x).sum())
    assert float(result) == 64 ** 3
    assert any(e["cat"] == "cpu_op" for e in events)
    summary = tracing.trace_summary(events)
    assert summary["device_events"] == 0 and summary["window_s"] > 0


class FakeEvent:
    def __init__(self, name, device):
        self._name, self._device = name, device

    def name(self):
        return self._name

    def device_type(self):
        return f"DeviceType.{self._device}"


@pytest.mark.parametrize("name, device, cat", [
    ("rk4_fused_kernel<double>", "CUDA", "kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "CUDA", "gpu_memcpy"),
    ("Memset (Device)", "CUDA", "gpu_memset"),
    ("cudaLaunchKernel", "CPU", "cuda_runtime"),
    ("aten::to", "CPU", "cpu_op")])
def test_categories(name, device, cat):
    assert tracing._category(FakeEvent(name, device)) == cat
