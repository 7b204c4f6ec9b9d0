"""The double-float ensemble cell (``maooam36.ens-twofloat``) on the CPU,
cut to 8 members and 60 steps: it runs through the runner with the port's
twofloat integrator (on the CPU its plain double-float step loop) and
comes out ``correct`` against the extended-precision reference on members
drawn from the seed, far inside its limits; the control (the plain
reference in float32 in the program's place) comes out not ``correct``.
The extended reference is wider than float64, and against it the
double-float tier reads between float32 and float64: float32 is the
precision below the cell's, and float64 lies above it."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import control
from portbench.harness import checks, loader
from portbench.harness.qgconfig import build_params
from portbench.reference import extended, qg
from portbench.reference import stand_in as si
from portbench.tests.conftest import SEED, run_cpu

CELL = "maooam36.ens-twofloat"


def shrink_twofloat(cell):
    """The cell cut to 8 members, 60 steps of dt 0.1 and a record every 20
    steps, 4 members compared; no kernel launch expected."""
    p = cell["traffic"]["params"]
    p.update(members=8, t1=6.0, write_steps=20, ic_pool=2,
             reference_members=4)
    wl = cell["workload"]
    wl["expect_launches"] = {k: 0 for k in wl["expect_launches"]}
    wl["trace_calls"] = 2
    wl["check"]["calls"] = 3


def test_the_job_runs_the_twofloat_integrator():
    seen = {}

    def edit_job(job, ctx):
        seen["precision"] = job.integrator.precision
        seen["members"] = job.members

    result = run_cpu(CELL, edit=shrink_twofloat, edit_job=edit_job)
    assert seen["precision"] == "twofloat"
    assert len(seen["members"]) == 4 and len(set(seen["members"])) == 4
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"traj_steps_per_s", "setup_s"}
    assert result["checks"]["traj_gap"]["value"] < 1e-13
    assert loader.cell(CELL)["config"]["name"] == "maooam36"


def test_the_control_is_refused():
    def edit(cell):
        shrink_twofloat(cell)
        control.no_launches(cell)

    result = run_cpu(CELL, edit=edit, edit_job=control.stand_in)
    assert result["correct"] is False
    failed = {k for k, c in result["checks"].items()
              if c["value"] > c["limit"]}
    assert {"tensor_gap", "traj_gap_first", "traj_gap"} <= failed


def test_the_cell_compares_a_sample_with_the_extended_reference():
    cell = loader.cell(CELL)
    p = cell["traffic"]["params"]
    assert (p["members"], p["reference_members"]) == (4096, 32)
    frozen = qg.load_tensor(cell["config"])
    ctx = SimpleNamespace(
        config=cell["config"], params=p, frozen=frozen,
        device=torch.device("cpu"), f=None,
        rng=lambda s: np.random.default_rng([SEED, s]), sync=lambda: None)
    job = cell["job"].Job(ctx)
    assert len(job.members) == 32 and (np.diff(job.members) > 0).all()
    assert job.members.max() < 4096


def _extended_and_float64(members, steps, write_steps):
    frozen = qg.load_tensor(loader.config("maooam36"))
    ic = np.random.default_rng(SEED).random((members, 36)) * 0.01
    t1 = steps * 0.1
    ext = extended.integrate(extended.Quadratic(frozen), ic, 0., t1, 0.1,
                             write_steps)
    f64 = qg.integrate(qg.Quadratic(frozen), ic, 0., t1, 0.1, write_steps)
    return frozen, ic, t1, ext, f64


def test_the_extended_reference_is_wider_than_float64():
    assert np.finfo(extended.EXTENDED).nmant > np.finfo(np.float64).nmant
    _, _, _, ext, f64 = _extended_and_float64(4, 200, 50)
    assert ext.dtype == extended.EXTENDED and ext.shape == (4, 36, 5)
    gap = checks.var_gap(f64, torch.as_tensor(ext.astype(np.float64)))
    # float64's own rounding: more than the extended format's, far less
    # than the double-float tier's
    assert 0 < gap < 1e-14


def test_a_host_without_a_wider_longdouble_is_refused(monkeypatch):
    monkeypatch.setattr(extended, "EXTENDED", np.float64)
    with pytest.raises(RuntimeError, match="no wider than float64"):
        extended.Quadratic(qg.load_tensor(loader.config("maooam36")))


def test_twofloat_reads_between_float32_and_float64():
    """Against the extended reference, 300 steps: float32 reads above the
    cell's limits, the double-float tier below them and above float64."""
    from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
    from qgs_tpu_torch.models.tendencies import create_tendencies
    from qgs_tpu_torch.params.params import QgParams

    frozen, ic, t1, ext, _ = _extended_and_float64(4, 300, 100)
    ref = torch.as_tensor(ext.astype(np.float64))
    f, _ = create_tendencies(build_params(
        QgParams, loader.config("maooam36")["qgparams"]), device="cpu")
    gaps = {}
    for name in ("twofloat", "float64"):
        integrator = RungeKuttaIntegrator(precision=name)
        integrator.set_func(f)
        integrator.integrate(0., t1, 0.1, ic=ic, write_steps=100)
        gaps[name] = checks.var_gap(integrator.get_trajectories()[1], ref)
    plain32 = si.Integrator(frozen, torch.float32, "cpu")
    plain32.integrate(0., t1, 0.1, ic=ic, write_steps=100)
    gaps["float32"] = checks.var_gap(plain32.get_trajectories()[1], ref)
    limit = loader.cell(CELL)["workload"]["check"]["limits"]["traj_gap"]
    assert gaps["float32"] > limit > gaps["twofloat"]
    assert gaps["twofloat"] > 4 * gaps["float64"]
