"""The port's rank-5 and diagnostics examples (``qgs_tpu_torch.examples``:
``dynamic_temperature``, ``t4_radiation`` and ``diagnostics_tour``) against
the JAX package's computation.

Each test runs the port's ``main(device="cpu", short=True, plot=False)``
and rebuilds the JAX example's computation with ``qgs_tpu`` from the same
parameters, the same seeded NumPy inputs and the same short lengths (the
JAX scripts are neither run nor edited).  Tolerances: float64 trajectories
rtol 1e-9, atol 1e-11 (``tests/test_trajectory.py:57``); twofloat against
float64 as float64 (PERF.md section 2); a diagnostic's field against the
JAX package's diagnostic of the port's own trajectory rtol 1e-12, atol
1e-12 x max|field|; the direct tangent against the dense Jacobian's
product within ten times what the JAX script prints (at least 1e-13).
The two-level layout's slots stay within its bound of 1.5 an entry.  Each
example that draws runs once more with ``plot=True`` on Agg into
``tmp_path``."""

import jax.numpy as jnp
import numpy as np
import pytest

from qgs_tpu.diagnostics.eddy import (
    MiddleAtmosphericEddyHeatFluxDiagnostic as JaxEddy,
    MiddleAtmosphericEddyHeatFluxProfileDiagnostic as JaxEddyProfile)
from qgs_tpu.diagnostics.streamfunctions import (
    LowerLayerAtmosphericStreamfunctionDiagnostic as JaxPsiLower,
    MiddleAtmosphericStreamfunctionDiagnostic as JaxPsi,
    UpperLayerAtmosphericStreamfunctionDiagnostic as JaxPsiUpper)
from qgs_tpu.diagnostics.temperatures import (
    AtmosphericTemperatureMeridionalGradientDiagnostic as JaxGradient,
    MiddleAtmosphericTemperatureAnomalyDiagnostic as JaxTheta)
from qgs_tpu.diagnostics.vorticity import (
    MiddleAtmosphericVorticityDiagnostic as JaxVorticity,
    UpperLayerAtmosphericPotentialVorticityDiagnostic as JaxPV)
from qgs_tpu.diagnostics.wind import (
    MiddleAtmosphericUWindDiagnostic as JaxU,
    MiddleAtmosphericVWindDiagnostic as JaxV,
    MiddleAtmosphericWindIntensityDiagnostic as JaxIntensity,
    MiddleLayerVerticalVelocity as JaxOmega)
from qgs_tpu.integrators.integrator import RungeKuttaIntegrator as JaxRK
from qgs_tpu.integrators.rk import integrate_runge_kutta as jax_integrate
from qgs_tpu.models.tendencies import create_tendencies as jax_tendencies
from qgs_tpu.ops.contraction import make_direct_tangent as jax_tangent
from qgs_tpu.params.params import QgParams as JaxQgParams

from tests.test_torch_examples_models import (check_plots,  # noqa: F401
                                              one_torch_thread, runs)
from qgs_tpu_torch.examples import (diagnostics_tour, dynamic_temperature,
                                    rp_atmosphere, t4_radiation)
from qgs_tpu_torch.ops.contraction import SLOT_BOUND

F64 = dict(rtol=1e-9, atol=1e-11)
FIELD = 1e-12           # rtol, and atol as a share of max|field|

# the JAX package's classes in the order of the port example's catalog
JAX_CATALOG = (JaxPsiLower, JaxPsiUpper, JaxPsi, JaxTheta, JaxGradient, JaxU,
               JaxV, JaxIntensity, JaxOmega, JaxVorticity, JaxPV, JaxEddy)

PLOTS = {"dynamic_temperature": ["dynT_temperatures.png"],
         "t4_radiation": ["t4_series.png"],
         "diagnostics_tour": ["diagnostics_tour.png", "eddy_profile.png"]}


def field_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=FIELD,
                               atol=FIELD * np.nanmax(np.abs(ref)),
                               equal_nan=True)


def test_dynamic_temperature(runs):
    out = runs("dynamic_temperature")
    times = dynamic_temperature.TIMES[True]
    pars = dynamic_temperature.params(JaxQgParams)
    f, Df, tensor = jax_tendencies(pars, return_qgtensor=True)
    x0 = dynamic_temperature.initial_state(pars)
    vr = pars.variables_range
    _, y = jax_integrate(f.batched, 0., times["series"], 0.01, x0,
                         write_steps=100)
    np.testing.assert_allclose(out["series"], np.asarray(y)[vr[0]], **F64)
    _, traj = jax_integrate(f.batched, 0., times["span"], 0.01, x0,
                            write_steps=100)
    traj = np.asarray(traj)
    np.testing.assert_allclose(out["traj"], traj, **F64)

    # the JAX script's check, on the port's last state
    x_end = out["traj"][:, -1]
    xx = jnp.concatenate([jnp.ones(1), jnp.asarray(x_end)])[None, :]
    dm = jnp.eye(pars.ndim)[None, :, :4]
    J = np.asarray(Df.batched(0., jnp.asarray(x_end)[None, :]))[0]
    direct = np.asarray(jax_tangent(tensor.jacobian_tensor)(xx, dm))[0]
    jax_err = float(np.abs(direct - J @ np.asarray(dm[0])).max())
    np.testing.assert_allclose(out["direct"], direct, rtol=1e-12,
                               atol=1e-15)
    assert out["err"] <= 10 * max(jax_err, 1e-14)


def test_t4_radiation(runs):
    out = runs("t4_radiation")
    times = t4_radiation.TIMES[True]
    pars = t4_radiation.params(JaxQgParams)
    f, _, tensor = jax_tendencies(pars, return_qgtensor=True)
    x0 = dynamic_temperature.initial_state(pars)
    _, y = jax_integrate(f.batched, 0., times["first"], 0.01, x0,
                         write_steps=0)
    np.testing.assert_allclose(out["y_first"], np.asarray(y), **F64)
    _, traj = jax_integrate(f.batched, 0., times["span"], 0.01, x0,
                            write_steps=50)
    np.testing.assert_allclose(out["traj"], np.asarray(traj), **F64)
    _, y64 = jax_integrate(f.batched, 0., times["df"], 0.01, x0[None, :],
                           write_steps=0)
    y64 = np.asarray(y64)
    np.testing.assert_allclose(out["y64"], y64, **F64)
    np.testing.assert_allclose(out["ydf"], y64[None], **F64)   # unsqueezed
    assert out["err"] < 1e-12
    kept = int(np.count_nonzero(np.asarray(tensor.tensor.coords)[0]))
    assert kept <= out["slots"] <= SLOT_BOUND * kept


def test_diagnostics_tour(runs):
    out = runs("diagnostics_tour")
    times = diagnostics_tour.TIMES[True]
    pars = rp_atmosphere.params(JaxQgParams)
    f, _ = jax_tendencies(pars)
    integ = JaxRK()
    integ.set_func(f)
    rng = np.random.default_rng(0)
    integ.integrate(0., times["transient"], 0.1,
                    ic=rng.random(pars.ndim) * 0.1, write_steps=0)
    _, y0 = integ.get_trajectories()
    integ.integrate(0., times["span"], 0.1, ic=y0, write_steps=10)
    t, traj = integ.get_trajectories()
    np.testing.assert_allclose(out["traj"], np.asarray(traj), **F64)
    assert len(out["fields_last"]) == len(JAX_CATALOG)
    for got, cls in zip(out["fields_last"], JAX_CATALOG):
        field_close(got, np.asarray(cls(pars)(np.asarray(t),
                                              out["traj"]))[-1])
    profile = JaxEddyProfile(pars)(np.asarray(t), out["traj"])
    field_close(out["profile_last"], np.asarray(profile)[-1])


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_plots(runs, tmp_path, name):
    check_plots(runs, tmp_path, name, PLOTS[name])
