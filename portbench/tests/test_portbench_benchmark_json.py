"""``BENCHMARK.json`` at the repository's root and the benchmark's files
agree: every cell has its workload file with the same configuration,
traffic, chips and why, and lists exactly the metrics that name it;
every metric has a reader with the same unit; every configuration's file
names the same source."""

import json
import re

import pytest

from portbench.harness import loader
from portbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    path = REPO / "BENCHMARK.json"
    if not path.exists():
        pytest.skip("no BENCHMARK.json beside the benchmark")
    return json.loads(path.read_text())


def cells_of(metric, bench):
    return metric.get("workloads", [w["name"] for w in bench["workloads"]])


def test_cells(bench):
    for w in bench["workloads"]:
        wl = loader.workload(w["name"])
        assert {k: wl[k] for k in ("config", "traffic", "chips", "why")} \
            == {k: w[k] for k in ("config", "traffic", "chips", "why")}
        for kind in ("end_to_end", "per_layer"):
            named = {m["name"] for m in bench[kind]
                     if w["name"] in cells_of(m, bench)}
            assert set(wl[kind]) == named, (w["name"], kind)


def test_metrics(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"])
        assert loader.metric(m["name"]).UNIT == m["unit"]
        if m in bench["per_layer"]:
            assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
            for cell in cells_of(m, bench):
                moved = next(e for e in bench["end_to_end"]
                             if e["name"] == m["moves"])
                assert cell in cells_of(moved, bench)


def test_configs(bench):
    for c in bench["configs"]:
        cfg = loader.config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"


def test_budget(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert 1 <= bench["run_seconds"] <= 51 and total <= 43200
