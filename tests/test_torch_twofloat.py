"""The port's double-float (twofloat) tier against the JAX package on the
CPU: the same numpy-seeded inputs through ``qgs_tpu`` and ``qgs_tpu_torch``.

* The error-free transformations are exact, and the double-float ops equal
  the JAX package's eager ones bit for bit.
* ``DfTendency`` and the plain RK4 step against *eager* JAX
  ``make_df_quadratic`` / ``make_df_rk4_step_dynamic`` with
  ``accumulate='strict'`` (XLA:CPU under ``jit`` strips the EFT barriers):
  atol 1e-14; only the summation order of a row differs.
* The plain version of the fused kernel against the interpreted Pallas
  kernel K2 (whose trace XLA:CPU compiles, barriers stripped): 1e-8.
* ``RungeKuttaIntegrator(precision='twofloat')`` against the JAX float64
  integrator: rtol 1e-9, atol 1e-11, the trajectory tolerance of
  ``tests/test_trajectory.py:57``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgs_tpu.integrators.integrator import (
    RungeKuttaIntegrator as JaxRungeKuttaIntegrator,
)
from qgs_tpu.integrators.rk import integrate_runge_kutta as jax_integrate
from qgs_tpu.integrators.rk import rk2_tableau as jax_rk2_tableau
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu.ops import twofloat as jtf
from qgs_tpu.ops.pallas_kernels import make_pallas_df_rk4
from qgs_tpu.params.params import QgParams
from qgs_tpu_torch.params.params import QgParams as PortQgParams
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.integrators.rk import integrate_runge_kutta_df, rk2_tableau
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops import fused_df_rk4
from qgs_tpu_torch.ops import twofloat as tf

from tests.test_torch_host import both_params, maooam as maooam_settings
from tests.test_trajectory import _maooam_params

TOL = dict(rtol=1e-9, atol=1e-11)


def _maooam_4x4_params():
    """The odd-row-width configuration of ``tests/test_twofloat.py:91``."""
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(4, 4)
    pars.set_oceanic_basin_fourier_modes(4, 4)
    pars.set_params({'kd': 0.029, 'kdp': 0.029, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    return pars


@pytest.fixture(scope="module")
def maooam():
    pars = _maooam_params()
    f, _, qgt = jax_create_tendencies(pars, return_qgtensor=True)
    return pars, f, qgt.tensor


def _port(tensor):
    return tf.DfTendency(tensor.coords, tensor.data, tensor.shape,
                         device="cpu")


def _np(pair):
    return tuple(np.asarray(p) for p in pair)


def test_error_free_transforms_are_exact():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4096).astype(np.float32)
    b = rng.standard_normal(4096).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)

    s, e = tf.two_sum(ta, tb)
    assert np.array_equal(s.double().numpy() + e.double().numpy(), a64 + b64)
    p, e = tf.two_prod(ta, tb)
    assert np.array_equal(p.double().numpy() + e.double().numpy(), a64 * b64)
    hi, lo = tf.split(ta)
    assert np.array_equal(hi.double().numpy() + lo.double().numpy(), a64)
    assert not (hi.numpy().view(np.uint32) & 0xFFF).any()
    s, e = tf.quick_two_sum(ta, tb * np.float32(1e-3))
    assert np.array_equal(s.double().numpy() + e.double().numpy(),
                          a64 + (b * np.float32(1e-3)).astype(np.float64))


DF_OPS = {
    "add": (lambda m, x, y: m.df_add(x, y)),
    "mul": (lambda m, x, y: m.df_mul(x, y)),
    "scale": (lambda m, x, y: m.df_scale(x, np.float32(2.0))),
    "div_scalar": (lambda m, x, y: m.df_div_scalar(x, 6.0)),
    "reduce_last_15": (lambda m, x, y: m.df_reduce_last(
        tuple(p.reshape(-1, 15) for p in x))),
    "reduce_last_24": (lambda m, x, y: m.df_reduce_last(
        tuple(p.reshape(-1, 24) for p in x))),
}


@pytest.mark.parametrize("op", list(DF_OPS))
def test_df_ops_equal_eager_jax_bit_for_bit(op):
    rng = np.random.default_rng(1)
    a64, b64 = rng.standard_normal((2, 1080))
    xt = tf.df_from_f64(torch.as_tensor(a64))
    yt = tf.df_from_f64(torch.as_tensor(b64))
    xj = jtf.df_from_f64(jnp.asarray(a64))
    yj = jtf.df_from_f64(jnp.asarray(b64))
    assert all(np.array_equal(p.numpy(), q) for p, q in zip(xt, _np(xj)))
    got = DF_OPS[op](tf, xt, yt)
    ref = _np(DF_OPS[op](jtf, xj, yj))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), r)
    assert np.array_equal(tf.df_to_f64(got).numpy(),
                          np.asarray(jtf.df_to_f64(tuple(map(jnp.asarray,
                                                             ref)))))


@pytest.mark.parametrize("make_params", [_maooam_params, _maooam_4x4_params],
                         ids=["maooam", "maooam_4x4"])
def test_df_tendency_matches_eager_jax(make_params):
    pars = make_params()
    _, _, qgt = jax_create_tendencies(pars, return_qgtensor=True)
    T = qgt.tensor
    rng = np.random.default_rng(2)
    x = rng.random((4, pars.ndim)) * 0.05
    xx = np.concatenate([np.ones((4, 1)), x], axis=1)
    quad = jtf.make_df_quadratic(T, accumulate="strict")
    ref = np.asarray(jtf.df_to_f64(quad(jtf.df_from_f64(jnp.asarray(xx)))))
    out = _port(T)(*tf.df_from_f64(torch.as_tensor(x)))
    assert out[0].dtype == torch.float32 and out[0].shape == (4, pars.ndim)
    np.testing.assert_allclose(tf.df_to_f64(out).numpy(), ref[:, 1:],
                               rtol=0, atol=1e-14)


def test_df_rk4_step_matches_eager_jax(maooam):
    pars, _, T = maooam
    x = np.random.default_rng(3).random((4, pars.ndim)) * 0.05
    step_j = jtf.make_df_rk4_step_dynamic(T, accumulate="strict")
    step_p = tf.make_df_rk4_step_dynamic(_port(T))
    yj = jtf.df_from_f64(jnp.asarray(x))
    yp = tf.df_from_f64(torch.as_tensor(x))
    for dt in [0.1] * 9 + [0.05]:
        yj = step_j(yj, 0., dt)
        yp = step_p(yp, 0., dt)
    np.testing.assert_allclose(tf.df_to_f64(yp).numpy(),
                               np.asarray(jtf.df_to_f64(yj)), rtol=0,
                               atol=1e-14)


def test_reference_matches_interpreted_pallas_kernel(maooam):
    pars, _, T = maooam
    x = np.random.default_rng(4).random((8, pars.ndim)) * 0.05
    run = make_pallas_df_rk4(T, 0.1, n_steps=10, batch_block=4,
                             interpret=True)
    y_pallas = np.asarray(jtf.df_to_f64(run(*jtf.df_from_f64(
        jnp.asarray(x)))))
    (yh, yl), (rh, rl) = fused_df_rk4.fused_df_rk4_reference(
        _port(T), *tf.df_from_f64(torch.as_tensor(x)), np.full(10, 0.1), 5)
    assert yh.dtype == torch.float32 and rh.shape == (2, 8, pars.ndim)
    np.testing.assert_allclose(tf.df_to_f64((yh, yl)).numpy(), y_pallas,
                               rtol=0, atol=1e-8)
    assert torch.equal(rh[-1], yh) and torch.equal(rl[-1], yl)


@pytest.mark.parametrize("forward", [True, False], ids=["forward", "backward"])
def test_twofloat_integrator_matches_jax_float64(forward):
    jax_pars, pars = both_params(maooam_settings)
    f_jax, _ = jax_create_tendencies(jax_pars)
    f_port, _ = create_tendencies(pars, device="cpu")
    ic = np.random.default_rng(5).random((3, pars.ndim)) * 0.01
    kw = dict(t0=0., t=30.05, dt=0.1, write_steps=7, forward=forward)
    ij = JaxRungeKuttaIntegrator()
    ij.set_func(f_jax)
    ij.integrate(ic=ic, **kw)
    t_j, y_j = ij.get_trajectories()
    ip = RungeKuttaIntegrator(precision="twofloat")
    ip.set_func(f_port)
    ip.integrate(ic=ic, **kw)
    t_p, y_p = ip.get_trajectories()
    assert np.array_equal(t_p, t_j)
    assert y_p.dtype == torch.float64 and tuple(y_p.shape) == np.shape(y_j)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), **TOL)


def test_twofloat_rk2_matches_jax_float64(maooam):
    """Heun's method in double-float against JAX float64 RK2 over 50 steps
    (``tests/test_twofloat.py:324-348``); RK2 and RK4 differ."""
    pars, f, T = maooam
    x0 = np.random.default_rng(11).random((3, pars.ndim)) * 0.05
    aj, bj, cj = jax_rk2_tableau()
    _, y64 = jax_integrate(f.batched, 0., 5., 0.1, x0, write_steps=0,
                           a=aj, b=bj, c=cj)
    a, b, c = rk2_tableau()
    _, ydf = integrate_runge_kutta_df(_port(T), 0., 5., 0.1, x0,
                                      write_steps=0, squeeze=False, a=a, b=b,
                                      c=c)
    np.testing.assert_allclose(ydf.numpy(), np.asarray(y64), **TOL)
    _, y4 = integrate_runge_kutta_df(_port(T), 0., 5., 0.1, x0,
                                     write_steps=0, squeeze=False)
    assert np.abs(y4.numpy() - ydf.numpy()).max() > 1e-6

    integ = RungeKuttaIntegrator(a=a, b=b, c=c, precision="twofloat")
    integ.set_func(create_tendencies(maooam_settings(PortQgParams),
                                     device="cpu")[0])
    integ.integrate(0., 5., 0.1, ic=x0, write_steps=0)
    assert torch.equal(integ.get_trajectories()[1], ydf)


def test_twofloat_errors(maooam):
    pars = maooam_settings(PortQgParams)
    f_port, _ = create_tendencies(pars, device="cpu")
    x0 = np.full(pars.ndim, 0.01)

    integ = RungeKuttaIntegrator(precision="twofloat")
    integ.set_func(f_port.batched)             # carries no .qgtensor
    with pytest.raises(RuntimeError, match="qgtensor"):
        integ.integrate(0., 1., 0.1, ic=x0, write_steps=0)

    implicit = RungeKuttaIntegrator(a=np.array([[0.5]]), b=np.array([1.0]),
                                    c=np.array([0.5]), precision="twofloat")
    implicit.set_func(f_port)
    with pytest.raises(ValueError, match="explicit"):
        implicit.integrate(0., 1., 0.1, ic=x0, write_steps=0)

    with pytest.raises(ValueError, match="unknown precision"):
        RungeKuttaIntegrator(precision="float32")
