"""The port's examples of the models and the contract
(``qgs_tpu_torch.examples``: ``rp_atmosphere``, ``maooam_coupled``,
``ground_coupled``, ``precision_tiers``, ``external_solvers`` and
``kernel_selection``) against the JAX package's computation.

Each test runs the port's ``main(device="cpu", short=True, plot=False)``
and rebuilds the JAX example's computation with ``qgs_tpu`` from the same
parameters, the same seeded NumPy inputs and the same short lengths (the
JAX scripts are neither run nor edited).  Tolerances:

* float64 trajectories rtol 1e-9, atol 1e-11 (``tests/test_trajectory.py:57``:
  only the summation order differs);
* a diagnostic's field against the JAX package's diagnostic of the port's
  own trajectory, rtol 1e-12, atol 1e-12 x max|field|;
* float32 against float64 rtol 1e-4, atol 1e-6, twofloat against float64
  as float64 (PERF.md section 2);
* Lyapunov exponents 1e-9, the twofloat ones against float64 5e-8
  (``tests/test_lyapunov.py:380-409``);
* scipy's adaptive solutions on the two packages' ``f`` rtol 1e-8 (its
  step choice can differ by rounding), within 1e-4 of max|y| of the RK4
  (``examples/external_solvers.py:69``).

Each example that draws runs once more with ``plot=True`` on Agg into
``tmp_path``: its files exist, and its numbers equal the ``plot=False``
run's."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from qgs_tpu.diagnostics.multi import MultiDiagnostic as JaxMulti
from qgs_tpu.diagnostics.streamfunctions import (
    MiddleAtmosphericStreamfunctionDiagnostic as JaxPsi,
    OceanicLayerStreamfunctionDiagnostic as JaxOceanPsi,
)
from qgs_tpu.diagnostics.temperatures import (
    GroundTemperatureAnomalyDiagnostic as JaxGroundT,
    MiddleAtmosphericTemperatureAnomalyDiagnostic as JaxTheta,
    OceanicLayerTemperatureAnomalyDiagnostic as JaxOceanT,
)
from qgs_tpu.diagnostics.variables import VariablesDiagnostic as JaxVariables
from qgs_tpu.integrators.integrator import RungeKuttaIntegrator as JaxRK
from qgs_tpu.integrators.rk import integrate_runge_kutta as jax_integrate
from qgs_tpu.integrators.rk import make_rk_step, rk4_tableau
from qgs_tpu.models.tendencies import create_tendencies as jax_tendencies
from qgs_tpu.ops.contraction import make_tendency_fns as jax_fns
from qgs_tpu.params.params import QgParams as JaxQgParams
from qgs_tpu.toolbox.lyapunov import LyapunovsEstimator as JaxLyapunov

from qgs_tpu_torch.examples import (external_solvers, ground_coupled,
                                    kernel_selection, maooam_coupled,
                                    precision_tiers, rp_atmosphere)

F64 = dict(rtol=1e-9, atol=1e-11)
F32 = dict(rtol=1e-4, atol=1e-6)
LYAP = dict(rtol=1e-9, atol=1e-9)
LYAP_DF = dict(rtol=5e-8, atol=5e-8)
FIELD = 1e-12           # rtol, and atol as a share of max|field|
IVP = 1e-8

PLOTS = {"rp_atmosphere": ["rp_variables.png", "rp_psi.png"],
         "maooam_coupled": ["maooam_dashboard.png"]}


# the fixtures and check_plots below are shared by the other
# test_torch_examples_* files

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: one intra-op thread (see ``test_torch_lyapunov.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """Each example's ``main(device="cpu", short=True, plot=False)``, run
    once for this module."""
    cache = {}

    def run(name):
        if name not in cache:
            mod = importlib.import_module(f"qgs_tpu_torch.examples.{name}")
            cache[name] = mod.main(device="cpu", short=True, plot=False)
        return cache[name]
    return run


def field_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=FIELD,
                               atol=FIELD * np.nanmax(np.abs(ref)))


def jax_run(pars, seed, scale, transient, span, write_steps):
    """The JAX examples' sequence: a transient from a seeded random state,
    then a recorded run from its last state."""
    f, _ = jax_tendencies(pars)
    integ = JaxRK()
    integ.set_func(f)
    rng = np.random.default_rng(seed)
    integ.integrate(0., transient, 0.1, ic=rng.random(pars.ndim) * scale,
                    write_steps=0)
    _, y0 = integ.get_trajectories()
    integ.integrate(0., span, 0.1, ic=y0, write_steps=write_steps)
    t, traj = integ.get_trajectories()
    return np.asarray(t), np.asarray(traj)


def test_rp_atmosphere(runs):
    out = runs("rp_atmosphere")
    times = rp_atmosphere.TIMES[True]
    pars = rp_atmosphere.params(JaxQgParams)
    t, traj = jax_run(pars, 21217, 0.1, times["transient"], times["span"], 5)
    np.testing.assert_array_equal(out["time"], t)
    np.testing.assert_allclose(out["traj"], traj, **F64)
    ref = JaxVariables([0, 1, 2], pars, dimensional=False)(t, out["traj"])
    np.testing.assert_allclose(out["variables"], np.asarray(ref), **F64)
    psi = JaxPsi(pars, geopotential=True)(t, out["traj"])
    field_close(out["psi_last"], np.asarray(psi)[-1])


def test_maooam_coupled(runs):
    out = runs("maooam_coupled")
    times = maooam_coupled.TIMES[True]
    pars = maooam_coupled.params(JaxQgParams)
    t, traj = jax_run(pars, 0, 0.01, times["transient"], times["span"], 20)
    np.testing.assert_array_equal(out["time"], t)
    np.testing.assert_allclose(out["traj"], traj, **F64)
    m = JaxMulti(2, 2)
    for cls in (JaxPsi, JaxTheta, JaxOceanPsi, JaxOceanT):
        m.add_diagnostic(cls(pars))
    fields = m(t, out["traj"])
    assert out["fields_last"].shape[0] == 4
    for got, ref in zip(out["fields_last"], fields):
        field_close(got, np.asarray(ref)[-1])


def test_ground_coupled(runs):
    out = runs("ground_coupled")
    times = ground_coupled.TIMES[True]
    pars = ground_coupled.params(JaxQgParams)
    t, traj = jax_run(pars, 0, 0.05, times["transient"], times["span"], 10)
    np.testing.assert_array_equal(out["time"], t)
    np.testing.assert_allclose(out["traj"], traj, **F64)
    field = np.asarray(JaxGroundT(pars)(t, out["traj"]))
    field_close(out["field_range"], [field.min(), field.max()])


def test_precision_tiers(runs):
    """The JAX script's fori_loops of its RK4 step (float64, float32), at
    the short run's step count; the port's twofloat run against float64;
    the Lyapunov spectra from the port's start state."""
    out = runs("precision_tiers")
    times = precision_tiers.TIMES[True]
    pars = precision_tiers.params(JaxQgParams)
    f, Df, tensor = jax_tendencies(pars, return_qgtensor=True)
    x = np.random.default_rng(0).random((precision_tiers.B, pars.ndim)) \
        * 0.05
    a, b, c = rk4_tableau()
    ys = {}
    for name, fn, dtype in (
            ("y64", f.batched, jnp.float64),
            ("y32", jax_fns(tensor.tensor, tensor.jacobian_tensor,
                            dtype=jnp.float32)[0], jnp.float32)):
        step = make_rk_step(fn, a, b, c)
        run = jax.jit(lambda y, step=step: jax.lax.fori_loop(
            0, times["steps"], lambda i, y: step(
                y, jnp.asarray(0.0, y.dtype), jnp.asarray(0.1, y.dtype)), y))
        ys[name] = np.asarray(run(jnp.asarray(x, dtype)), np.float64)
    np.testing.assert_allclose(out["y64"], ys["y64"], **F64)
    np.testing.assert_allclose(out["y32"], ys["y64"], **F32)
    np.testing.assert_allclose(out["y32"], ys["y32"], **F32)
    np.testing.assert_allclose(out["ydf"], ys["y64"], **F64)
    assert out["err32"] == np.abs(out["y32"] - out["y64"]).max() < 1e-4
    assert out["errdf"] < 1e-12
    assert set(out["rates"]) == {"float64", "float32", "twofloat"}

    est = JaxLyapunov()
    est.set_func(f, Df)
    est.compute_lyapunovs(0., times["tw"], times["t"], 0.1, 0.1,
                          out["ydf"][:1], write_steps=1)
    m64 = np.asarray(est.get_lyapunovs()[2]).mean(-1)
    np.testing.assert_allclose(out["lyap64"], m64, **LYAP)
    np.testing.assert_allclose(out["lyapdf"], m64, **LYAP_DF)


def test_external_solvers(runs):
    """The JAX script's sequence on the JAX package's ``f``: its RK4 spin-up
    and record, and scipy's RK45 and LSODA."""
    out = runs("external_solvers")
    times = external_solvers.TIMES[True]
    pars = external_solvers.params(JaxQgParams)
    f, Df = jax_tendencies(pars)
    ic = np.random.default_rng(21).random(pars.ndim) * 0.01
    _, y0 = jax_integrate(f.batched, 0., times["transient"], 0.1, ic,
                          write_steps=0)
    y0 = np.asarray(y0)
    span = times["span"]
    t_eval = np.arange(0., span + 0.001, 0.1)
    _, native = jax_integrate(f.batched, 0., span, 0.1, y0, write_steps=1)
    np.testing.assert_allclose(out["native"], np.asarray(native), **F64)
    scale = np.abs(out["native"]).max()
    for key, kw in (("rk45", dict(method="RK45")),
                    ("lsoda", dict(method="LSODA",
                                   jac=lambda t, y: np.asarray(Df(t, y))))):
        sol = solve_ivp(lambda t, y: np.asarray(f(t, y)), (0., span), y0,
                        t_eval=t_eval, rtol=1e-10, atol=1e-12, **kw)
        assert sol.status == 0
        np.testing.assert_allclose(out[key], sol.y, rtol=IVP,
                                   atol=IVP * scale)
    assert out["err_rk45"] < external_solvers.BOUND
    assert out["err_lsoda"] < external_solvers.BOUND


def test_kernel_selection(runs):
    """Every mode name is the one gather path (deviation exactly 0), equal
    to the JAX package's bucketed kernel; each precision's integration
    against the JAX package's float64 one; on the CPU nothing is
    launched."""
    out = runs("kernel_selection")
    pars = maooam_coupled.params(JaxQgParams)
    f, _, qgt = jax_tendencies(pars, return_qgtensor=True)
    fb, _ = jax_fns(qgt.tensor, qgt.jacobian_tensor, mode="bucketed")
    x = np.random.default_rng(0).random((4, pars.ndim)) * 0.05
    ref = np.asarray(fb(0., jnp.asarray(x)))
    np.testing.assert_allclose(out["f_auto"], ref, rtol=1e-13,
                               atol=1e-16 * np.abs(ref).max())
    assert set(out["deviations"].values()) == {0.0}
    ic = np.random.default_rng(1).random((kernel_selection.B, pars.ndim)) \
        * 0.01
    _, y64 = jax_integrate(f.batched, 0., kernel_selection.TIMES[True]["span"],
                           0.1, ic, write_steps=0)
    y64 = np.asarray(y64)
    np.testing.assert_allclose(out["y_float64"], y64, **F64)
    np.testing.assert_allclose(out["y_float32"], y64, **F32)
    np.testing.assert_allclose(out["y_twofloat"], y64, **F64)
    for counts in out["launches"].values():
        assert counts == {"rk4_fused": 0, "rk4_df_fused": 0}


def check_plots(runs, tmp_path, name, files):
    """``main(plot=True)`` on Agg writes ``files`` into ``outdir``, and its
    numbers are the ``plot=False`` run's."""
    mod = importlib.import_module(f"qgs_tpu_torch.examples.{name}")
    out = mod.main(device="cpu", short=True, plot=True, outdir=str(tmp_path))
    for fname in files:
        assert (tmp_path / fname).stat().st_size > 0
    ref = runs(name)
    for key in mod.TOLERANCES:
        np.testing.assert_array_equal(out[key], ref[key])


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_plots(runs, tmp_path, name):
    check_plots(runs, tmp_path, name, PLOTS[name])
