"""The 12x12 channel atmosphere's cell (``atm600.ens-f64``) on the CPU:
its files load and agree with the frozen tensor; its job, run on the port
over the frozen tensor (the set-up's ``create_tendencies`` takes about two
minutes at this width, so the runner's set-up is left to the card), cut
to 4 members and 20 steps, is within the cell's limits of the reference,
and the reference in float32 is not; the streamed K1's roofline reads the
single-buffer variant's kernel, and gives None without a trace or a
streamed kernel."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.harness import checks, loader
from portbench.harness.qgconfig import build_params
from portbench.reference import qg
from portbench.tests.conftest import SEED

CELL = "atm600.ens-f64"


def test_the_files_load_and_agree():
    cell = loader.cell(CELL)
    cfg, wl = cell["config"], cell["workload"]
    assert cfg["name"] == wl["config"] == "atm600" and cfg["reduced"] == []
    frozen = qg.load_tensor(cfg)
    assert frozen.coords.shape == (3, cfg["tensor_entries"])
    assert frozen.shape == (cfg["ndim"] + 1,) * 3
    rows = np.bincount(frozen.coords[0], minlength=cfg["ndim"] + 1)
    assert rows.max() == 1743          # the longest output row
    p = cell["traffic"]["params"]
    assert len(qg.time_grid(p["t0"], p["t1"], p["dt"])) - 1 == 100
    assert wl["expect_launches"] == {"k1_resident": 0, "k1_streamed": 1,
                                     "k2_resident": 0, "k2_streamed": 0}
    for metric in wl["end_to_end"] + wl["per_layer"]:
        assert loader.metric(metric).UNIT


def test_the_block_builds_ndim_600():
    from qgs_tpu_torch.params.params import QgParams

    pars = build_params(QgParams, loader.config("atm600")["qgparams"])
    assert pars.ndim == 600


def _job(members, steps):
    """The cell's job over the frozen tensor, the port's tendency built
    from it on the CPU, cut to ``members`` and ``steps``."""
    from qgs_tpu_torch.ops.contraction import Tendency

    cell = loader.cell(CELL)
    cfg, p = cell["config"], dict(cell["traffic"]["params"])
    p.update(members=members, t1=steps * p["dt"], ic_pool=2)
    p.pop("reference_members")
    frozen = qg.load_tensor(cfg)
    ctx = SimpleNamespace(
        config=cfg, params=p, frozen=frozen, device=torch.device("cpu"),
        f=Tendency(frozen.coords, frozen.data, frozen.shape, device="cpu"),
        rng=lambda s: np.random.default_rng([SEED, s]), sync=lambda: None)
    return cell, cell["job"].Job(ctx)


def test_the_job_is_within_the_limits():
    cell, job = _job(4, 20)
    limits = cell["workload"]["check"]["limits"]
    key, out = job.call(1)
    assert out.shape == (4, 600, 3)
    ref = job.reference([key], torch.float64)[0]
    gaps = job.compare(out, ref)
    assert gaps["traj_gap_first"] <= limits["traj_gap_first"]
    assert gaps["traj_gap"] <= limits["traj_gap"]
    # far below the limits: the same arithmetic to rounding
    assert gaps["traj_gap"] < 1e-13
    ref32 = job.reference([key], torch.float32)[0]
    gaps32 = job.compare(ref32, ref)
    assert gaps32["traj_gap_first"] > limits["traj_gap_first"]
    assert gaps32["traj_gap"] > limits["traj_gap"]


def _readings(ops, calls=1, bound_s=0.5):
    trace = None if ops is None else {
        "window_s": 2.0, "busy_s": 1.9, "device_events": len(ops) or 1,
        "ops": ops, "gaps": []}
    return SimpleNamespace(trace=trace, calls=calls,
                           job=SimpleNamespace(k1_bound_s=bound_s))


def test_the_streamed_roofline_reads_the_variants_kernel():
    """The cell reads the streamed K1's accepted roofline, whose fragment
    matches the single-buffer variant's kernel name too."""
    assert "k1_streamed_roofline" in loader.cell(CELL)["workload"][
        "per_layer"]
    read = loader.metric("k1_streamed_roofline").read
    ops = {"void (anonymous namespace)::rk4_streamed_kernel_1buf<double>"
           "(int4 const*, int const*, int, int, double*, int, double "
           "const*, int, int, double*, double*)": [1.0, 1],
           "Memcpy HtoD (Pageable -> Device)": [0.01, 1]}
    assert read(_readings(ops)) == pytest.approx(50.0)
    assert read(_readings(None)) is None     # an untraced run
    assert read(_readings({"Memcpy HtoD (Pageable -> Device)": [0.01, 1]})
                ) is None                    # no streamed kernel
    assert loader.metric("outside_kernel_ms.ens").read(
        _readings(ops)) == pytest.approx(1e3 * (2.0 - 1.0))
