"""The port's toolbox examples (``qgs_tpu_torch.examples``:
``lyapunov_exponents``, ``clv_walkthrough``, ``ensemble_statistics`` and
``distributed_ensembles``) against the JAX package's computation.

Each test runs the port's ``main(device="cpu", short=True, plot=False)``
and rebuilds the JAX example's computation with ``qgs_tpu`` from the same
parameters, the same seeded NumPy inputs and the same short lengths (the
JAX scripts are neither run nor edited; the JAX script's ``initialize``
draws its start from an unseeded generator, and the port's example runs
that sequence from seeded draws, rebuilt here).  Tolerances:
float64 trajectories rtol 1e-9, atol 1e-11 (``tests/test_trajectory.py:57``);
Lyapunov exponents 1e-9 (``tests/test_lyapunov.py``); angles between CLVs
1e-6 degrees (arccos amplifies the vectors' rounding near 0); the
covariance check's alignments as the JAX script prints them, to 1e-9; a
CLV's streamfunction pattern rtol 1e-9, atol 1e-9 x max|field|.  The
distributed example runs its two-process self-test over gloo.  Each
example that draws runs once more with ``plot=True`` on Agg into
``tmp_path``."""

import jax.numpy as jnp
import numpy as np
import pytest

from qgs_tpu.diagnostics.util import create_grid_basis as jax_grid_basis
from qgs_tpu.integrators.integrator import RungeKuttaIntegrator as JaxRK
from qgs_tpu.integrators.rk import make_rk_step, make_tgls_step, rk4_tableau
from qgs_tpu.integrators.statistics import (
    TrajectoriesStatistics as JaxStatistics)
from qgs_tpu.models.tendencies import create_tendencies as jax_tendencies
from qgs_tpu.params.params import QgParams as JaxQgParams
from qgs_tpu.toolbox.lyapunov import (
    CovariantLyapunovsEstimator as JaxCovariant,
    LyapunovsEstimator as JaxLyapunov)

from tests.test_torch_examples_models import (check_plots,  # noqa: F401
                                              one_torch_thread, runs)
from qgs_tpu_torch.examples import (clv_walkthrough, distributed_ensembles,
                                    ensemble_statistics, external_solvers,
                                    lyapunov_exponents, maooam_coupled,
                                    rp_atmosphere)

F64 = dict(rtol=1e-9, atol=1e-11)
LYAP = dict(rtol=1e-9, atol=1e-9)
ANGLES = dict(rtol=1e-6, atol=1e-6)
PATTERN = 1e-9          # rtol, and atol as a share of max|field|

PLOTS = {"clv_walkthrough": ["clv_spectrum.png", "clv_local_exponent.png",
                             "clv_pattern.png", "clv_angles.png"],
         "ensemble_statistics": ["ensemble_spread.png"]}


def jax_transient(f, pars, seed, scale, transient):
    integ = JaxRK()
    integ.set_func(f)
    ic = np.random.default_rng(seed).random(pars.ndim) * scale
    integ.integrate(0., transient, 0.1, ic=ic, write_steps=0)
    return np.asarray(integ.get_trajectories()[1])


def test_lyapunov_exponents(runs):
    out = runs("lyapunov_exponents")
    times = lyapunov_exponents.TIMES[True]
    pars = rp_atmosphere.params(JaxQgParams)
    f, Df = jax_tendencies(pars)
    ic = jax_transient(f, pars, 1, 0.1, times["transient"])
    np.testing.assert_allclose(out["ic"], ic, **F64)

    est = JaxLyapunov()
    est.set_func(f, Df)
    est.compute_lyapunovs(0., times["tw"], times["t"], 0.1, 0.1, ic,
                          write_steps=10)
    spectrum = np.sort(np.asarray(est.get_lyapunovs()[2]).mean(-1))[::-1]
    np.testing.assert_allclose(out["spectrum"], spectrum, **LYAP)
    assert out["kaplan_yorke"] == (np.cumsum(spectrum) > 0).sum()

    cest = JaxCovariant()
    cest.set_func(f, Df)
    cest.compute_clvs(0., times["ta"], times["tb"], times["tc"], 0.1, 0.1,
                      ic, write_steps=10)
    cexps = np.asarray(cest.get_clvs()[2])
    np.testing.assert_allclose(out["clv_spectrum"], cexps.mean(-1), **LYAP)


def test_clv_walkthrough(runs):
    out = runs("clv_walkthrough")
    times = clv_walkthrough.TIMES[True]
    pars = external_solvers.params(JaxQgParams)
    f, Df = jax_tendencies(pars)
    ic = np.atleast_2d(jax_transient(f, pars, 3, 0.01, times["transient"]))
    np.testing.assert_allclose(out["ic"], ic, **F64)

    est = JaxLyapunov()
    est.set_func(f, Df)
    est.compute_lyapunovs(0., times["tw"], times["t"], 0.1, 0.1, ic,
                          write_steps=1)
    spectrum = np.sort(np.asarray(est.get_lyapunovs()[2]).mean(-1))[::-1]
    np.testing.assert_allclose(out["spectrum"], spectrum, **LYAP)

    cest = JaxCovariant()
    cest.set_func(f, Df)
    cest.compute_clvs(0., times["ta"], times["tb"], times["tc"], 0.1, 0.1,
                      ic, write_steps=1)
    _, traj, cexps, clvs = (np.asarray(a) for a in cest.get_clvs())
    np.testing.assert_allclose(out["clv_spectrum"],
                               np.sort(cexps.mean(-1))[::-1], **LYAP)
    lead = int(np.argmax(cexps.mean(-1)))
    ang = np.degrees(np.arccos(np.clip(np.abs(
        np.einsum('nt,nt->t', clvs[:, lead], clvs[:, lead + 1])), 0, 1)))
    np.testing.assert_allclose(out["angles"], ang, **ANGLES)

    X, Y = np.meshgrid(np.linspace(0, 2 * np.pi / pars.scale_params.n, 120),
                       np.linspace(0, np.pi, 60))
    grid = jax_grid_basis(pars.atmospheric_basis, X, Y)
    natm = pars.nmod[0]
    k = clvs.shape[-1] // 2
    for key, coeffs in (("psi_bg", traj[:natm, k]),
                        ("psi_v1", clvs[:natm, lead, k])):
        ref = np.tensordot(coeffs, grid, axes=(0, 0))
        np.testing.assert_allclose(out[key], ref, rtol=PATTERN,
                                   atol=PATTERN * np.abs(ref).max())

    a, b, c = rk4_tableau()
    step = make_tgls_step(f.batched, Df.batched, a, b, c)
    _, V2 = step((jnp.asarray(traj[:, k][None]),
                  jnp.asarray(clvs[:, :, k][None])), jnp.asarray(0.0),
                 jnp.asarray(0.1))
    V2 = np.array(V2)[0]
    V2 /= np.linalg.norm(V2, axis=0)
    align = [abs(np.dot(V2[:, j], clvs[:, j, k + 1])) for j in range(4)]
    np.testing.assert_allclose(out["align"], align, **F64)


def test_ensemble_statistics(runs):
    """The transient, the perturbed members' reconvergence and
    ``compute_stats`` of the JAX package from the example's seeded
    draws."""
    out = runs("ensemble_statistics")
    times = ensemble_statistics.TIMES[True]
    pars = rp_atmosphere.params(JaxQgParams)
    f, _ = jax_tendencies(pars)
    integ = JaxRK(number_of_dimensions=pars.ndim)
    integ.set_func(f)
    rng = np.random.default_rng(0)
    integ.integrate(0., times["convergence"], 0.1,
                    ic=rng.random(pars.ndim) * 0.1, write_steps=0)
    x0 = np.asarray(integ.get_trajectories()[1])
    stats = JaxStatistics()
    stats.set_integrator(integ)
    stats.initialize(times["reconvergence"], 0.1, ic=x0 + 0.01 * (
        rng.standard_normal((ensemble_statistics.MEMBERS, pars.ndim))))
    ic = np.asarray(stats.get_ic())
    np.testing.assert_allclose(out["ic"], ic, **F64)
    stats.set_func_list([lambda traj: traj, lambda traj: traj ** 2])
    stats.compute_stats(0., times["span"], 0.1, ic=ic, write_steps=10, num=2)
    mean, second = np.asarray(stats.get_stats())
    np.testing.assert_allclose(out["mean"], mean, **F64)
    np.testing.assert_allclose(out["second_moment"], second, **F64)


def test_distributed_ensembles(runs):
    """The split integration and the row-sharded step against the JAX
    package's unsplit ones; the two-process self-test's reports."""
    out = runs("distributed_ensembles")
    pars = maooam_coupled.params(JaxQgParams)
    f, _ = jax_tendencies(pars)
    ic = np.random.default_rng(7).random((distributed_ensembles.B,
                                          pars.ndim)) * 0.01
    integ = JaxRK()
    integ.set_func(f)
    integ.integrate(0., distributed_ensembles.TIMES[True]["span"], 0.1,
                    ic=ic, write_steps=100)
    np.testing.assert_allclose(out["traj"],
                               np.asarray(integ.get_trajectories()[1]), **F64)
    a, b, c = rk4_tableau()
    y = make_rk_step(f.batched, a, b, c)(jnp.asarray(ic), jnp.asarray(0.0),
                                        jnp.asarray(0.1))
    np.testing.assert_allclose(out["sharded_step"], np.asarray(y), **F64)
    assert out["err"] == 0.0
    assert len(out["reports"]) == 2
    for r in out["reports"]:
        assert "mesh={'ensemble': 2, 'model': 2}" in r
        assert "model-rowshard" in r


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_plots(runs, tmp_path, name):
    check_plots(runs, tmp_path, name, PLOTS[name])
