"""The reference's ``f(t, x)`` / ``Df(t, x)`` contract on NumPy states.

The port's ``f``, ``Df``, ``f.batched`` and ``Df.batched`` take NumPy
states and return ``np.ndarray`` (float64), equal to the JAX package's on
the same inputs on RP (ndim 20), MAOOAM (36) and T4 (38) to rtol 1e-13 with
an atol of 1e-16 x max|ref| (only the summation order differs); a tensor
input still returns a tensor.  ``scipy.integrate.solve_ivp`` (RK45, rtol
1e-10, atol 1e-12) on RP over 10 time units, once on the port's ``f`` and
once on the JAX package's, agrees at ``t_eval`` to rtol 1e-8 (adaptive step
choice can differ by rounding), and both stay within the bound of
``examples/external_solvers.py:69`` (1e-4 of max|y|) of the port's own
RK4.  The twofloat ``DfTendency`` and the tangent modules keep the same
rule."""

import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from qgs_tpu.models.tendencies import (
    create_tendencies as jax_create_tendencies)
from qgs_tpu_torch.integrators.rk import integrate_runge_kutta
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops.contraction import make_direct_tangent
from qgs_tpu_torch.ops.twofloat import (DfTangent, DfTendency, df_from_f64,
                                        df_to_f64)

from tests.test_torch_host import both_params, maooam, rp, t4

RTOL = 1e-13            # port against the JAX package, the same inputs
ATOL_SCALE = 1e-16      # atol, as a share of max|ref|
TOL_IVP = 1e-8          # solve_ivp on the port's f against the JAX package's
BOUND_RK4 = 1e-4        # examples/external_solvers.py:69, share of max|y|

CONFIGS = {"rp": rp, "maooam": maooam, "t4": t4}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: one intra-op thread (see ``test_torch_lyapunov.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    jax_pars, pars = both_params(CONFIGS[request.param])
    f, Df, qgt = create_tendencies(pars, return_qgtensor=True, device="cpu")
    jf, jDf = jax_create_tendencies(jax_pars)
    return pars.ndim, (f, Df, qgt), (jf, jDf)


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=ATOL_SCALE * np.abs(ref).max())


def test_numpy_in_numpy_out(models):
    n, (f, Df, _), (jf, jDf) = models
    rng = np.random.default_rng(n)
    x = rng.random(n) * 0.05
    xs = rng.random((5, n)) * 0.05
    for got, ref in ((f(0., x), jf(0., x)), (Df(0., x), jDf(0., x)),
                     (f.batched(0., xs), jf.batched(0., xs)),
                     (Df.batched(0., xs), jDf.batched(0., xs))):
        assert type(got) is np.ndarray and got.dtype == np.float64
        assert got.shape == np.shape(ref)
        _close(got, ref)
    # any array-like: a list of floats is a state too
    np.testing.assert_array_equal(f(0., list(x)), f(0., x))


def test_tensor_in_tensor_out(models):
    n, (f, Df, _), _ = models
    x = np.random.default_rng(n).random((3, n)) * 0.05
    xt = torch.as_tensor(x)
    for fn, arg in ((f, xt[0]), (Df, xt[0]), (f.batched, xt),
                    (Df.batched, xt)):
        out = fn(0., arg)
        assert isinstance(out, torch.Tensor) and out.dtype == torch.float64
        np.testing.assert_array_equal(out.numpy(), fn(0., arg.numpy()))


def test_twofloat_and_tangents_on_numpy(models):
    """``DfTendency`` on NumPy (hi, lo) pairs, ``Tangent`` and ``DfTangent``
    on NumPy states and tangent blocks: NumPy out, equal to the tensor
    call."""
    n, (f, Df, qgt), _ = models
    x = np.random.default_rng(1).random((2, n)) * 0.05
    dfn = DfTendency(qgt.tensor.coords, qgt.tensor.data, qgt.tensor.shape,
                     device="cpu")
    pair = df_from_f64(torch.as_tensor(x))
    got = dfn(*(p.numpy() for p in pair))
    assert all(type(p) is np.ndarray and p.dtype == np.float32 for p in got)
    ref = dfn(*pair)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())
    np.testing.assert_allclose(df_to_f64(tuple(map(torch.as_tensor, got))),
                               f.batched(0., x), rtol=1e-12, atol=1e-14)

    xx = np.concatenate([np.ones((2, 1)), x], axis=1)
    dm = np.broadcast_to(np.eye(n)[:, :4], (2, n, 4)).copy()
    hom = make_direct_tangent(qgt.jacobian_tensor, device="cpu")
    got = hom(xx, dm)
    assert type(got) is np.ndarray
    np.testing.assert_array_equal(got, hom(torch.as_tensor(xx),
                                           torch.as_tensor(dm)).numpy())
    np.testing.assert_allclose(got, Df.batched(0., x) @ dm, rtol=1e-12,
                               atol=1e-14)
    jt = qgt.jacobian_tensor
    dhom = DfTangent(jt.coords, jt.data, jt.shape, device="cpu")
    xx_df = df_from_f64(torch.as_tensor(xx))
    dm_df = df_from_f64(torch.as_tensor(dm))
    got = dhom(tuple(p.numpy() for p in xx_df),
               tuple(p.numpy() for p in dm_df))
    for g, r in zip(got, dhom(xx_df, dm_df)):
        assert type(g) is np.ndarray
        np.testing.assert_array_equal(g, r.numpy())


def test_solve_ivp_on_the_ports_f():
    """RK45 on RP over 10 time units from an attractor state: the port's
    ``f`` against the JAX package's, and both against the port's RK4."""
    jax_pars, pars = both_params(rp)
    f, _ = create_tendencies(pars, device="cpu")
    jf, _ = jax_create_tendencies(jax_pars)
    ic = np.random.default_rng(21).random(pars.ndim) * 0.01
    _, y0 = integrate_runge_kutta(f.batched, 0., 200., 0.1, ic, write_steps=0)
    y0 = y0.numpy()
    t_eval = np.arange(0., 10.001, 0.1)
    sols = [solve_ivp(lambda t, y: np.asarray(fn(t, y)), (0., 10.), y0,
                      method="RK45", t_eval=t_eval, rtol=1e-10, atol=1e-12)
            for fn in (f, jf)]
    for sol in sols:
        assert sol.status == 0 and sol.y.shape == (pars.ndim, t_eval.size)
    scale = np.abs(sols[1].y).max()
    np.testing.assert_allclose(sols[0].y, sols[1].y, rtol=TOL_IVP,
                               atol=TOL_IVP * scale)
    _, y_rk4 = integrate_runge_kutta(f.batched, 0., 10., 0.1, y0,
                                     write_steps=1)
    y_rk4 = y_rk4.numpy()
    for sol in sols:
        assert np.abs(sol.y - y_rk4).max() / np.abs(y_rk4).max() < BOUND_RK4
