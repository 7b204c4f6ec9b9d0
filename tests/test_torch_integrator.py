"""The port's ``RungeKuttaIntegrator`` against the JAX package's on the CPU,
float64: the same seeded initial conditions through both, equal record
times, and trajectories within the trajectory tolerance of
``tests/test_trajectory.py:57`` (rtol 1e-9, atol 1e-11)."""

import numpy as np
import pytest
import torch

from qgs_tpu.integrators.integrator import (
    RungeKuttaIntegrator as JaxRungeKuttaIntegrator,
)
from qgs_tpu.integrators.rk import infer_ndim as jax_infer_ndim
from qgs_tpu.integrators.rk import integrate_runge_kutta as jax_integrate
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.integrators.rk import (infer_ndim, integrate_runge_kutta,
                                         rk2_tableau)
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops import fused_rk4

from qgs_tpu_torch.params.params import QgParams

from tests.test_torch_host import both_params, maooam, rp

TOL = dict(rtol=1e-9, atol=1e-11)


@pytest.fixture(scope="module", params=[maooam, rp], ids=["maooam", "rp"])
def both(request):
    """The port's QgParams and the two packages' tendencies of one
    configuration, the port's on the CPU."""
    jax_pars, pars = both_params(request.param)
    f_jax, _ = jax_create_tendencies(jax_pars)
    f_port, _ = create_tendencies(pars, device="cpu")
    return pars, f_jax, f_port


def _run(integrator_cls, f, ic, **kw):
    integ = integrator_cls()
    integ.set_func(f)
    integ.integrate(ic=ic, **kw)
    t, traj = integ.get_trajectories()
    return t, traj


CASES = {
    "300_steps_write_5": dict(t0=0., t=30., dt=0.1, write_steps=5),
    "shorter_last_step": dict(t0=0., t=1.05, dt=0.1, write_steps=5),
    "write_steps_0": dict(t0=0., t=30., dt=0.1, write_steps=0),
    "backward": dict(t0=0., t=30., dt=0.1, write_steps=5, forward=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_integrator_matches_jax(both, case):
    pars, f_jax, f_port = both
    ic = np.random.default_rng(21217).random((3, pars.ndim)) * 0.01
    t_j, y_j = _run(JaxRungeKuttaIntegrator, f_jax, ic, **CASES[case])
    t_p, y_p = _run(RungeKuttaIntegrator, f_port, ic, **CASES[case])
    assert isinstance(t_p, (np.ndarray, float)) and torch.is_tensor(y_p)
    assert np.array_equal(t_p, t_j)
    assert tuple(y_p.shape) == np.shape(y_j)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), **TOL)


@pytest.mark.parametrize("write_steps", [5, 0])
def test_single_state_squeezes_like_jax(both, write_steps):
    pars, f_jax, f_port = both
    ic = np.random.default_rng(3).random(pars.ndim) * 0.01
    kw = dict(t0=0., t=3., dt=0.1, write_steps=write_steps)
    t_j, y_j = _run(JaxRungeKuttaIntegrator, f_jax, ic, **kw)
    t_p, y_p = _run(RungeKuttaIntegrator, f_port, ic, **kw)
    assert np.array_equal(t_p, t_j)
    assert tuple(y_p.shape) == np.shape(y_j)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), **TOL)


def test_initialize_with_ic_matches_jax(both):
    pars, f_jax, f_port = both
    ic = np.random.default_rng(8).random((2, pars.ndim)) * 0.01
    ij, ip = JaxRungeKuttaIntegrator(), RungeKuttaIntegrator()
    ij.set_func(f_jax)
    ip.set_func(f_port)
    ij.initialize(10., 0.1, ic=ic)
    ip.initialize(10., 0.1, ic=ic)
    assert tuple(ip.get_ic().shape) == ij.get_ic().shape == (2, pars.ndim)
    np.testing.assert_allclose(ip.get_ic().numpy(), ij.get_ic(), **TOL)

    # the stored ic feeds the next integration, as in the reference
    ij.integrate(0., 1., 0.1, write_steps=0)
    ip.integrate(0., 1., 0.1, write_steps=0)
    np.testing.assert_allclose(ip.get_trajectories()[1].numpy(),
                               np.asarray(ij.get_trajectories()[1]), **TOL)


def test_initialize_draws_from_the_given_rng():
    pars = rp(QgParams)
    f, _ = create_tendencies(pars, device="cpu")
    ics = []
    for _ in range(2):
        integ = RungeKuttaIntegrator()
        integ.set_func(f)
        integ.initialize(2., 0.1, number_of_trajectories=3, reconverge=True,
                         reconvergence_time=1., rng=np.random.default_rng(5))
        ics.append(integ.get_ic())
    assert ics[0].shape == (3, pars.ndim)
    assert torch.equal(ics[0], ics[1])
    assert integ.n_dim == pars.ndim

    with pytest.raises(ValueError, match="rng"):
        integ.initialize(2., 0.1, number_of_trajectories=3)


def test_cpu_integration_launches_no_kernel(both):
    pars, _, f_port = both
    ic = np.random.default_rng(9).random((2, pars.ndim)) * 0.01
    _run(RungeKuttaIntegrator, f_port, ic, t0=0., t=2., dt=0.1)
    assert fused_rk4.launches == 0


def test_rk2_tableau_matches_jax(both):
    pars, f_jax, f_port = both
    from qgs_tpu.integrators.rk import rk2_tableau as jax_rk2
    ic = np.random.default_rng(10).random((2, pars.ndim)) * 0.01
    a, b, c = rk2_tableau()
    aj, bj, cj = jax_rk2()
    t_j, y_j = jax_integrate(f_jax.batched, 0., 3., 0.1, ic, write_steps=4,
                             a=aj, b=bj, c=cj)
    t_p, y_p = integrate_runge_kutta(f_port.batched, 0., 3., 0.1, ic,
                                     write_steps=4, a=a, b=b, c=c)
    assert np.array_equal(t_p, t_j)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), **TOL)


def test_float32_tendency_integrates_in_float32(both):
    pars, f_jax, _ = both
    f32, _ = create_tendencies(pars, dtype=torch.float32, device="cpu")
    ic = np.random.default_rng(11).random((2, pars.ndim)) * 0.01
    _, y32 = _run(RungeKuttaIntegrator, f32, ic, t0=0., t=5., dt=0.1,
                  write_steps=0)
    assert y32.dtype == torch.float32
    _, y64 = _run(JaxRungeKuttaIntegrator, f_jax, ic, t0=0., t=5., dt=0.1,
                  write_steps=0)
    np.testing.assert_allclose(y32.numpy(), np.asarray(y64), rtol=1e-4,
                               atol=1e-6)


def test_dimension_autoprobe_matches_jax(both):
    pars, f_jax, f_port = both
    assert infer_ndim(f_port.batched) == jax_infer_ndim(f_jax.batched) \
        == pars.ndim
    t_j, traj_j = jax_integrate(f_jax.batched, 0., 1., 0.1)
    t, traj = integrate_runge_kutta(f_port.batched, 0., 1., 0.1)
    assert np.array_equal(t, t_j) and traj.shape[0] == pars.ndim
    np.testing.assert_allclose(traj.numpy(), np.asarray(traj_j), **TOL)


def test_twofloat_needs_the_function_device(both):
    """The twofloat tier runs on the tendency function's device: a function
    that carries the model's tensor but no device raises, and does not
    fall back to the CPU."""
    pars, _, f_port = both

    def f_plain(t, x):
        return f_port.batched(t, x)

    f_plain.qgtensor = f_port.qgtensor
    integ = RungeKuttaIntegrator(precision="twofloat")
    integ.set_func(f_plain)
    with pytest.raises(RuntimeError, match="device"):
        integ.integrate(0., 1., 0.1,
                        ic=np.zeros((1, pars.ndim)), write_steps=0)
