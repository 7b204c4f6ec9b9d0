"""The quartic T4 cell and the ensemble at B=1024 on the CPU: each runs
through the runner with its traffic shrunk and comes out ``correct``;
the control (the plain reference in float32 in the program's place)
comes out not ``correct`` on the T4 cell; its frozen tensor loads against
the configuration's block and equals the port's; the T4 cell's four
readers read the port's span and counters and return None on a trace, a
job or a port without them."""

from types import SimpleNamespace

import pytest
import torch

from portbench import control
from portbench.harness import checks, loader
from portbench.reference import qg, quartic
from portbench.tests.conftest import run_cpu

T4 = "maooam38t4.ens-f64"
B1024 = "maooam228.ens-f64-b1024"
READERS = ("rk4_rank5_roofline", "launches_per_step.t4",
           "contract_host_ms.t4", "evals_per_step.t4")


def shrink_t4(cell):
    """The T4 cell cut to 8 members, 60 steps of dt 0.01 and a record every
    20 steps; no kernel launch expected."""
    p = cell["traffic"]["params"]
    p.update(members=8, t1=0.6, write_steps=20, ic_pool=2)
    p.pop("reference_members")
    wl = cell["workload"]
    wl["expect_launches"] = {k: 0 for k in wl["expect_launches"]}
    wl["trace_calls"] = 2
    wl["check"]["calls"] = 3


def test_the_t4_cell_is_correct():
    result = run_cpu(T4, edit=shrink_t4)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"traj_steps_per_s", "setup_s"}
    # far below its limit: the same arithmetic to rounding
    assert result["checks"]["traj_gap"]["value"] < 1e-13


def test_the_b1024_cell_is_correct():
    result = run_cpu(B1024)
    assert result["correct"] is True and result["failed"] == 0


def test_the_t4_control_is_refused():
    def edit(cell):
        shrink_t4(cell)
        control.no_launches(cell)

    result = run_cpu(T4, edit=edit, edit_job=control.stand_in)
    assert result["correct"] is False
    failed = {k for k, c in result["checks"].items()
              if c["value"] > c["limit"]}
    assert {"tensor_gap", "traj_gap_first", "traj_gap"} <= failed


def test_the_control_integrates_the_quartic_model():
    """The control's stand-in computes the T4 model in float32: its
    rank-3 tendency is replaced by the rank-5 one."""
    seen = {}

    def edit_job(job, ctx):
        control.stand_in(job, ctx)
        seen["tendency"] = job.integrator.tendency

    run_cpu(T4, edit=shrink_t4, edit_job=edit_job)
    assert isinstance(seen["tendency"], quartic.Quartic)
    assert seen["tendency"].dtype == torch.float32


def test_initial_states_hold_the_set_temperatures():
    cell = loader.cell(T4)
    shrink_t4(cell)
    cfg = cell["config"]
    ctx = SimpleNamespace(params=cell["traffic"]["params"], config=cfg,
                          frozen=qg.load_tensor(cfg), f=None, device="cpu",
                          rng=lambda s: __import__("numpy").random
                          .default_rng([7, s]))
    job = cell["job"].Job(ctx)
    for ic in job.pool:
        assert (ic[:, 10] == 0.1).all() and (ic[:, 29] == 0.12).all()
        rest = ic[:, [v for v in range(38) if v not in (10, 29)]]
        assert (rest >= 0).all() and (rest < 0.01).all()
    assert job.steps_per_call == 60
    assert job.rk4_bound_s > 0


def test_the_frozen_tensor_is_the_ports():
    from qgs_tpu_torch.models.tendencies import create_tendencies
    from qgs_tpu_torch.params.params import QgParams
    from portbench.harness.qgconfig import build_params

    cfg = loader.config("maooam38t4")
    frozen = qg.load_tensor(cfg)
    assert frozen.coords.shape == (5, cfg["tensor_entries"])
    assert frozen.shape == (cfg["ndim"] + 1,) * 5
    pars = build_params(QgParams, cfg["qgparams"])
    assert pars.ndim == cfg["ndim"]
    _, _, qgt = create_tendencies(pars, return_qgtensor=True, device="cpu")
    assert checks.tensor_gap(qgt.tensor.coords, qgt.tensor.data,
                             frozen.coords, frozen.data) == 0.0


def test_a_traced_cpu_run_reads_the_span_and_counters(monkeypatch):
    """On the CPU the plain step loop runs: four two-level evaluations a
    RK4 step, each inside ``qgs.two_level``; no device operation, so the
    device trace's readers read nothing.  The counters start from 0, as in
    the benchmark's process, which runs one cell."""
    from qgs_tpu_torch.integrators import rk
    from qgs_tpu_torch.ops import contraction
    from qgs_tpu_torch.utils import profiling

    monkeypatch.setattr(contraction, "two_level_calls", 0)
    monkeypatch.setattr(rk, "plain_steps", 0)
    profiling.reset_spans()
    result = run_cpu(T4, trace=True, edit=shrink_t4)
    profiling.reset_spans()
    metrics = result["metrics"]
    assert metrics["evals_per_step.t4"]["value"] == 4.0
    assert metrics["contract_host_ms.t4"]["value"] > 0
    assert "rk4_rank5_roofline" not in metrics
    assert "launches_per_step.t4" not in metrics
    assert result["correct"] is True


def readings(trace=True, job=None):
    t = ({"window_s": 2.0, "busy_s": 1.0, "device_events": 600, "ops": {},
          "gaps": []} if trace else None)
    job = job or SimpleNamespace(rk4_bound_s=0.005, steps_per_call=500)
    return SimpleNamespace(trace=t, calls=2, job=job)


def test_the_readers_read():
    from qgs_tpu_torch.integrators import rk
    from qgs_tpu_torch.ops import contraction
    from qgs_tpu_torch.utils import profiling

    r = readings()
    assert loader.metric("rk4_rank5_roofline").read(r) == pytest.approx(1.0)
    assert loader.metric("launches_per_step.t4").read(r) == pytest.approx(0.6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "span_totals",
                   lambda: {"qgs.two_level": (4000, 0.08)})
        mp.setattr(contraction, "two_level_calls", 4004)
        mp.setattr(rk, "plain_steps", 1001)
        assert loader.metric("contract_host_ms.t4").read(r) == \
            pytest.approx(40.0)
        assert loader.metric("evals_per_step.t4").read(r) == \
            pytest.approx(4.0)


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_trace(name):
    assert loader.metric(name).read(readings(trace=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_span_or_counters(name, monkeypatch):
    """A port older than the span and counters, or a run in which neither
    a two-level contraction nor a plain step nor a device operation nor a
    rank-5 job was seen, reads nothing, and nothing raises."""
    from qgs_tpu_torch.integrators import rk
    from qgs_tpu_torch.ops import contraction
    from qgs_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "span_totals", lambda: {})
    monkeypatch.delattr(contraction, "two_level_calls")
    monkeypatch.delattr(rk, "plain_steps")
    r = readings(job=SimpleNamespace())
    r.trace.update(busy_s=0.0, device_events=0)
    assert loader.metric(name).read(r) is None


def test_no_plain_step_reads_nothing(monkeypatch):
    from qgs_tpu_torch.integrators import rk
    monkeypatch.setattr(rk, "plain_steps", 0)
    assert loader.metric("evals_per_step.t4").read(readings()) is None

