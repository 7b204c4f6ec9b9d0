"""The port stands on its own: a subprocess with ``jax`` and the JAX
package ``qgs_tpu`` blocked imports ``qgs_tpu_torch``, builds MAOOAM,
integrates 10 steps on the CPU in float64 and in twofloat, 3 steps of the
tangent-linear system and 2 Benettin windows, then runs the atmospheric
thermodynamic tendencies, ``QgsModel``, ``TrajectoriesStatistics`` and a
rank-5 (dynamic-T) model, diagnostics of the MAOOAM trajectory (omega
included) under the profiler's ``trace``, the integration split over a
four-entry CPU mesh and the RP driver, the NumPy backend and the native
oracle against the tendency, the symbolic products and export helpers, and
a reference-style script through the ``qgs`` alias of ``compat``; no
source file of the port imports either; every module of
``qgs_tpu_torch.examples`` imports with ``jax``, ``qgs_tpu`` and matplotlib
blocked (the card's host has no matplotlib), runs there with
``plot=False`` and raises ``ImportError`` with ``plot=True``; and the port
builds on the CUDA card unless asked for the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.models.tendencies import create_tendencies

from tests.test_torch_host import maooam

REPO = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
sys.modules["qgs_tpu"] = None      # and so does any of the JAX package
import numpy as np
import torch
import qgs_tpu_torch
from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator

pars = QgParams()
pars.set_atmospheric_channel_fourier_modes(2, 2)
pars.set_oceanic_basin_fourier_modes(2, 4)
f, Df, qgt = create_tendencies(pars, return_qgtensor=True, device="cpu")
assert qgt.tensor.shape == (37, 37, 37) and qgt.tensor.nnz > 0
integ = RungeKuttaIntegrator()
integ.set_func(f)
integ.integrate(0., 1., 0.1,
                ic=np.random.default_rng(0).random((4, pars.ndim)) * 0.01,
                write_steps=5)
t, traj = integ.get_trajectories()
assert tuple(traj.shape) == (4, 36, 3) and bool(traj.isfinite().all())
df = RungeKuttaIntegrator(precision="twofloat")
df.set_func(f)
df.integrate(0., 1., 0.1, ic=np.random.default_rng(0).random((4, pars.ndim))
             * 0.01, write_steps=5)
assert bool((df.get_trajectories()[1] - traj).abs().max() < 1e-12)

from qgs_tpu_torch.integrators import integrate
from qgs_tpu_torch.integrators.integrator import RungeKuttaTglsIntegrator
from qgs_tpu_torch.toolbox.lyapunov import compute_backward_lyapunovs
tgls = RungeKuttaTglsIntegrator()
tgls.set_func(f, Df)
tgls.integrate(0., 0.3, 0.1, ic=traj[:, :, -1], write_steps=1)
t, y, M = tgls.get_trajectories()
assert tuple(M.shape) == (4, 36, 36, 4) and bool(M.isfinite().all())
_, _, M1 = integrate.integrate_runge_kutta_tgls(
    f.batched, Df.batched, 0., 0.1, 0.1, traj[:, :, -1], np.eye(36),
    write_steps=0)
assert bool((M1 - M[..., 1]).abs().max() < 1e-12)
t, y, exps, vecs = compute_backward_lyapunovs(
    f.batched, Df.batched, 0., 0.1, 0.2, 0.1, 0.1, traj[:, :, -1],
    tensors=(qgt.tensor, qgt.jacobian_tensor))
assert tuple(vecs.shape) == (4, 36, 36, 2) and bool(exps.isfinite().all())

from qgs_tpu_torch.integrators.statistics import TrajectoriesStatistics
from qgs_tpu_torch.models.model import QgsModel
from qgs_tpu_torch.models.tendencies import create_atmo_thermo_tendencies
x = traj[:, :, -1]
assert tuple(create_atmo_thermo_tendencies(pars, device="cpu").batched(
    0., x).shape) == (4, 36)
model = QgsModel(pars, device="cpu")
assert bool((model.f.batched(0., x) - f.batched(0., x)).abs().max() == 0)
st = TrajectoriesStatistics()
st.set_integrator(integ)
st.set_func_list([lambda tr: tr[:, :, -1]])
assert tuple(st.compute_stats(0., 0.2, 0.1, ic=x, num=2).shape) == (1, 36)
dyn = QgParams({'rr': 287., 'sb': 5.6e-8}, dynamic_T=True)
dyn.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
dyn.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
dyn.set_oceanic_basin_fourier_modes(2, 4, mode='symbolic')
f5, Df5 = create_tendencies(dyn, device="cpu")
integ5 = RungeKuttaIntegrator()
integ5.set_func(f5)
integ5.integrate(0., 0.3, 0.1, ic=np.full((2, 38), 0.05), write_steps=0)
assert tuple(integ5.get_trajectories()[1].shape) == (2, 38)

import glob, os, tempfile
from qgs_tpu_torch.diagnostics.multi import MultiDiagnostic
from qgs_tpu_torch.diagnostics.streamfunctions import (
    MiddleAtmosphericStreamfunctionDiagnostic)
from qgs_tpu_torch.diagnostics.temperatures import (
    OceanicLayerTemperatureDiagnostic)
from qgs_tpu_torch.diagnostics.wind import MiddleLayerVerticalVelocity
from qgs_tpu_torch.utils.profiling import ThroughputMeter, trace
t, traj = integ.get_trajectories()
grid = dict(delta_x=0.5, delta_y=0.5, device="cpu")
with tempfile.TemporaryDirectory() as logdir:
    with trace(logdir), ThroughputMeter(36, 4) as meter:
        omega = MiddleLayerVerticalVelocity(pars, **grid)(t, traj[0])
        dash = MultiDiagnostic(1, 2)
        dash.add_diagnostic(MiddleAtmosphericStreamfunctionDiagnostic(
            pars, **grid))
        dash.add_diagnostic(OceanicLayerTemperatureDiagnostic(pars, **grid))
        psi, to = dash(t, traj[0])
        meter.add_steps(10)
    assert glob.glob(os.path.join(logdir, "*.pt.trace.json"))
assert psi.shape == omega.shape == to.shape and psi.shape[0] == 3
assert bool(omega.isfinite().all()) and meter.traj_steps_per_s > 0

import contextlib, io
from qgs_tpu_torch.drivers import qgs_maooam, qgs_rp
from qgs_tpu_torch.parallel import distributed, sharded_tendency
from qgs_tpu_torch.parallel.mesh import ensemble_mesh
ic4 = np.random.default_rng(0).random((4, pars.ndim)) * 0.01
split = RungeKuttaIntegrator(mesh=ensemble_mesh(["cpu"] * 4))
split.set_func(f)
split.integrate(0., 1., 0.1, ic=ic4, write_steps=5)
integ.integrate(0., 1., 0.1, ic=ic4, write_steps=5)
assert bool((split.get_trajectories()[1]
             - integ.get_trajectories()[1]).abs().max() == 0)
assert distributed.host_chip_mesh(2, ["cpu"] * 4).shape == {
    "ensemble": 2, "model": 2}
with tempfile.TemporaryDirectory() as d, \
        contextlib.redirect_stdout(io.StringIO()):
    t, y = qgs_rp.main(transient_time=1., integration_time=1.,
                       filename=os.path.join(d, "evol_fields.dat"),
                       device="cpu")
    assert np.loadtxt(os.path.join(d, "evol_fields.dat")).shape == (3, 21)
import shutil
import sympy
from qgs_tpu_torch import native
from qgs_tpu_torch.functions import symbolic_mul, symbolic_tendencies, util
from qgs_tpu_torch.models import numpy_backend
from qgs_tpu_torch.tensors.symbolic_qgtensor import SymbolicQgsTensor
x0 = ic4[0]
fx0 = f(0., torch.as_tensor(x0))
fn, Dfn = numpy_backend.make_numpy_tendencies(qgt.tensor, qgt.jacobian_tensor)
assert np.allclose(fn(0., x0), fx0.numpy(), rtol=1e-12, atol=1e-14)
if shutil.which("g++"):
    fc, Dfc = native.make_native_tendencies(qgt.tensor, qgt.jacobian_tensor)
    assert np.array_equal(fc(0., x0), fn(0., x0))
    assert np.array_equal(Dfc(0., x0), Dfn(0., x0))
a, b = sympy.symbols("a b")
tdic = SymbolicQgsTensor.simplify_dict({(1, 0, 1): a, (1, 1, 0): b})
prod = symbolic_mul.symbolic_sparse_mult3(tdic, [1, a], [1, b])
assert list(prod) == [1] and sympy.expand(prod[1] - a * b - b ** 2) == 0
assert symbolic_tendencies.translate_equations("x**2", "julia") == "x^2"
assert np.array_equal(util.reverse([1, 2, 3]), [3, 2, 1])

import qgs_tpu_torch.compat
from qgs.functions.tendencies import create_tendencies as alias_create
from qgs.integrators.integrator import RungeKuttaIntegrator as AliasRK
from qgs.params.params import QgParams as AliasParams
assert alias_create is create_tendencies and AliasRK is RungeKuttaIntegrator
pa = AliasParams()
pa.set_atmospheric_channel_fourier_modes(2, 2)
pa.set_oceanic_basin_fourier_modes(2, 4)
fa, _ = alias_create(pa, device="cpu")
assert bool(torch.equal(fa(0., torch.as_tensor(x0)), fx0))
assert sys.modules["jax"] is None and sys.modules["qgs_tpu"] is None
print("OK", sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "qgs_tpu")))
"""


def test_port_runs_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "QGS_TPU_X64"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK ['jax', 'qgs_tpu']", proc.stdout


EXAMPLES_SCRIPT = r"""
import importlib
import sys
for name in ("jax", "qgs_tpu", "matplotlib"):
    sys.modules[name] = None       # any import of these now raises
from qgs_tpu_torch import examples
mods = [importlib.import_module(f"qgs_tpu_torch.examples.{name}")
        for name in examples.NAMES]
assert len(mods) == 16 and all(callable(m.main) for m in mods)
from qgs_tpu_torch.examples import kernel_selection, rp_atmosphere
out = kernel_selection.main(device="cpu", short=True, plot=False)
assert set(out["deviations"].values()) == {0.0}
try:
    rp_atmosphere.main(device="cpu", short=True, plot=True)
except ImportError:
    pass
else:
    raise AssertionError("plot=True without matplotlib did not raise")
print("OK", sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "qgs_tpu", "matplotlib")))
"""


def test_examples_run_with_jax_and_matplotlib_blocked():
    proc = subprocess.run([sys.executable, "-c", EXAMPLES_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == \
        "OK ['jax', 'matplotlib', 'qgs_tpu']", proc.stdout


def test_no_port_source_imports_jax():
    """Neither the port nor chip_smoke.py imports jax or qgs_tpu."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|qgs_tpu)(?!_torch)\b",
                         re.MULTILINE)
    assert pattern.search("import qgs_tpu.params\n")
    assert pattern.search("    from qgs_tpu import native\n")
    assert pattern.search("from jax import numpy\n")
    assert not pattern.search("from qgs_tpu_torch.utils.sparse import COO\n")
    sources = sorted((REPO / "qgs_tpu_torch").rglob("*.py"))
    assert len(sources) > 20
    offenders = [str(p) for p in sources + [REPO / "chip_smoke.py"]
                 if pattern.search(p.read_text())]
    assert not offenders


def test_create_tendencies_defaults_to_the_card():
    """With no device, the tendencies are built on ``cuda``; where there is
    no card, the call raises and does not land on the CPU."""
    pars = maooam(QgParams)
    if torch.cuda.is_available():
        f, Df = create_tendencies(pars)
        assert f.batched.device.type == Df.batched.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            create_tendencies(pars)
