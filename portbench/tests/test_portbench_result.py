"""The result line: its keys in every cell, with and without the trace;
JSON without infinities; and ``run.py`` refusing a machine without a
card with no result line."""

import json
import math
import os
import subprocess
import sys

import pytest

from portbench.harness import loader
from portbench.tests.conftest import CELLS, REPO, run_cpu

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", CELLS)
def test_keys(name):
    result = run_cpu(name)
    assert list(result) == KEYS                 # checks comes last
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    wl = loader.workload(name)
    assert set(result["metrics"]) == set(wl["end_to_end"])
    for metric, m in result["metrics"].items():
        assert set(m) == {"value", "unit"}
        assert m["unit"] == loader.metric(metric).UNIT
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["checks"]) == set(wl["check"]["limits"])
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_keys_with_the_trace():
    result = run_cpu("maooam36.ens-f64", trace=True)
    assert list(result) == KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU there is no device work: its metrics are left out, the
    # host timers are read
    assert "mfu.ens" not in result["metrics"]
    assert result["metrics"]["setup.tendencies_s"]["value"] > 0


def test_json_has_no_infinity():
    sys.path.insert(0, str(REPO / "portbench"))
    import run
    out = json.dumps(run._finite({"a": [math.inf, 1.0], "b": math.nan}))
    assert json.loads(out) == {"a": [1e300, 1.0], "b": 1e300}


def test_no_card_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "maooam36.ens-f64", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "no CUDA card" in proc.stderr
