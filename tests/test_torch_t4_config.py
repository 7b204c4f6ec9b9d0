"""The quartic T4 configuration of the port's benchmark
(``portbench/configs/maooam38t4.json``) on the CPU:

* its ``qgparams`` block, applied call by call to a ``QgParams``, builds
  the tensor of the T4 example's constructor route
  (``QgParams(..., T4=True)``), bit for bit;
* ``RungeKuttaIntegrator.integrate`` of a rank-5 ``Tendency`` (the plain
  step loop over the two-level layout) matches the benchmark's plain
  rank-5 reference (``portbench/reference/quartic.py``), on seeded random
  rank-5 weights and on the T4 tensor.  Both compute the same products in
  float64 and differ only in the order of the sums (the two-level
  layout's chunks against ``index_add_`` entry by entry), so each
  variable's widest gap over its largest |value| stays near 1e-15 over
  these few steps; the tolerance ``REL`` = 1e-12 leaves that rounding a
  factor 100 and more, and a float32 run of the same, whose rounding is
  near 1e-7, fails it;
* the plain step loop counts its steps in ``rk.plain_steps`` and the
  two-level evaluations in ``contraction.two_level_calls`` (four a RK4
  step), and under a profiler each evaluation is a ``qgs.two_level``
  span."""

import json
import pathlib

import numpy as np
import pytest
import torch

from portbench.harness.qgconfig import build_params
from portbench.reference import qg, quartic
from qgs_tpu_torch.examples.t4_radiation import params as example_params
from qgs_tpu_torch.integrators import rk
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops import contraction
from qgs_tpu_torch.ops.contraction import Tendency
from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.utils import profiling

CONFIG = (pathlib.Path(__file__).resolve().parents[1] / "portbench"
          / "configs" / "maooam38t4.json")
REL = 1e-12
DT = 0.01


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def t4():
    """The configuration, its parameters and the port's T4 tensor."""
    cfg = json.loads(CONFIG.read_text())
    pars = build_params(QgParams, cfg["qgparams"])
    _, _, qgt = create_tendencies(pars, return_qgtensor=True, device="cpu")
    return cfg, pars, qgt.tensor


def random_rank5(n=8, nnz=200, seed=3):
    """Seeded random rank-5 COO weights of a model of n variables: entries
    of every order (trailing indices 0 give the lower ones), no output in
    the dummy row, values in [-1, 1)."""
    rng = np.random.default_rng(seed)
    coords = np.vstack([rng.integers(1, n + 1, nnz)]
                       + [rng.integers(0, n + 1, nnz) for _ in range(4)])
    return (coords, rng.uniform(-1.0, 1.0, nnz), (n + 1,) * 5)


def widest_gap(got, ref):
    """Each variable's widest gap over the records, over its largest
    |value| in the reference; the widest of them."""
    got, ref = torch.as_tensor(got, dtype=torch.float64), ref.double()
    diff = (got - ref).abs().amax(dim=(0, 2))
    return float((diff / ref.abs().amax(dim=(0, 2))).max())


def port_records(f, ic, steps, write_steps):
    integrator = RungeKuttaIntegrator()
    integrator.set_func(f)
    integrator.integrate(0., steps * DT, DT, ic=ic, write_steps=write_steps)
    return integrator.get_trajectories()[1]


def reference_records(tensor, ic, steps, write_steps):
    return qg.integrate(quartic.Quartic(tensor), ic, 0., steps * DT, DT,
                        write_steps)


def test_the_block_builds_the_examples_tensor(t4):
    cfg, pars, tensor = t4
    _, _, example = create_tendencies(example_params(), return_qgtensor=True,
                                      device="cpu")
    assert pars.ndim == cfg["ndim"] == 38
    assert np.asarray(tensor.coords).shape == (5, cfg["tensor_entries"])
    np.testing.assert_array_equal(np.asarray(tensor.coords),
                                  np.asarray(example.tensor.coords))
    np.testing.assert_array_equal(np.asarray(tensor.data),
                                  np.asarray(example.tensor.data))


@pytest.mark.parametrize("dtype, passes", [(torch.float64, True),
                                           (torch.float32, False)])
def test_random_rank5_against_the_reference(dtype, passes):
    coords, data, shape = random_rank5()
    ref_tensor = qg.FrozenTensor(coords, data, shape)
    ic = np.random.default_rng(4).uniform(0.0, 0.5, (8, 8))
    got = port_records(Tendency(coords, data, shape, dtype=dtype,
                                device="cpu"), ic, 20, 5)
    ref = reference_records(ref_tensor, ic, 20, 5)
    assert got.dtype == dtype and got.shape == ref.shape == (8, 8, 5)
    assert (widest_gap(got, ref) <= REL) is passes


@pytest.mark.parametrize("dtype, passes", [(torch.float64, True),
                                           (torch.float32, False)])
def test_t4_against_the_reference(t4, dtype, passes):
    cfg, pars, tensor = t4
    ic = 0.01 * np.random.default_rng(5).random((4, 38))
    ic[:, pars.variables_range[0]] = 0.1          # T_a0
    ic[:, pars.variables_range[2]] = 0.12         # T_o0
    f = Tendency(tensor.coords, tensor.data, tensor.shape, dtype=dtype,
                 device="cpu")
    got = port_records(f, ic, 50, 10)
    ref = reference_records(qg.FrozenTensor(np.asarray(tensor.coords),
                                            np.asarray(tensor.data),
                                            tensor.shape), ic, 50, 10)
    assert got.shape == ref.shape == (4, 38, 6)
    assert (widest_gap(got, ref) <= REL) is passes


def test_counters_and_span(monkeypatch):
    coords, data, shape = random_rank5()
    f = Tendency(coords, data, shape, device="cpu")
    ic = np.random.default_rng(6).uniform(0.0, 0.5, (2, 8))
    monkeypatch.setattr(rk, "plain_steps", 0)
    monkeypatch.setattr(contraction, "two_level_calls", 0)
    profiling.reset_spans()
    first, then = (len(rk.time_grid(0., k * DT, DT)) - 1 for k in (7, 3))
    port_records(f, ic, 7, 1)                       # no profiler: no span
    assert (rk.plain_steps, contraction.two_level_calls) == (first,
                                                             4 * first)
    assert "qgs.two_level" not in profiling.span_totals()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        port_records(f, ic, 3, 1)
    steps = first + then
    assert (rk.plain_steps, contraction.two_level_calls) == (steps,
                                                             4 * steps)
    count, seconds = profiling.span_totals()["qgs.two_level"]
    assert count == 4 * then and seconds > 0
    names = [e.name for e in prof.events()]
    assert names.count("qgs.two_level") == 4 * then
    profiling.reset_spans()
