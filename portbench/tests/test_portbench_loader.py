"""The loader finds each kind of file by name, refuses names that are no
names, and takes a new cell, traffic, job and metric dropped into a copy
of the benchmark as new files, with no file edited."""

import json
import shutil

import pytest

from portbench.harness import loader
from portbench.tests.conftest import CELLS, run_cpu


def test_every_cell_loads():
    for name in CELLS:
        cell = loader.cell(name)
        wl = cell["workload"]
        assert cell["config"]["name"] == wl["config"]
        assert hasattr(cell["job"], "Job")
        for metric in wl["end_to_end"] + wl["per_layer"]:
            assert loader.metric(metric).UNIT


@pytest.mark.parametrize("bad", ["../configs/maooam36", "a b", "", "x/y"])
def test_names_that_are_no_names(bad):
    with pytest.raises(ValueError):
        loader.workload(bad)


def test_a_missing_file():
    with pytest.raises(FileNotFoundError):
        loader.config("no-such-config")


def test_new_files_need_no_edit(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(loader.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "traffic" / "ens-tiny.json").write_text(json.dumps({
        "job": "ensemble_twice", "why": "a test's",
        "params": {"members": 4, "t0": 0.0, "t1": 2.0, "dt": 0.1,
                   "write_steps": 5, "ic_scale": 0.01, "ic_pool": 1}}))
    (root / "jobs" / "ensemble_twice.py").write_text(
        "from portbench.harness import loader\n"
        "Base = loader.job('ensemble').Job\n\n\n"
        "class Job(Base):\n"
        "    def __init__(self, ctx):\n"
        "        super().__init__(ctx)\n"
        "        self.units_per_call *= 2\n")
    (root / "metrics" / "calls_in_window.py").write_text(
        "UNIT = 'calls'\n\n\ndef read(r):\n    return r.calls\n")
    wl = json.loads((root / "workloads" / "maooam36.ens-f64.json")
                    .read_text())
    wl.update(traffic="ens-tiny", end_to_end=["calls_in_window",
                                              "traj_steps_per_s"],
              expect_launches={k: 0 for k in wl["expect_launches"]})
    (root / "workloads" / "maooam36.ens-tiny.json").write_text(
        json.dumps(wl))

    result = run_cpu("maooam36.ens-tiny", edit=None, root=root)
    assert result["correct"]
    calls = result["metrics"]["calls_in_window"]
    assert calls == {"value": result["attempted"], "unit": "calls"}
    assert result["metrics"]["traj_steps_per_s"]["value"] > 0
    assert all(p.read_bytes() == data for p, data in before.items())
