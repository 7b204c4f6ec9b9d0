"""The port's tangent-linear system against the JAX package's on the CPU:
the same numpy-seeded inputs through ``qgs_tpu`` and ``qgs_tpu_torch``
(``device="cpu"``), on MAOOAM (ndim 36) and on the qgs_rp orography system
of ``tests/test_tlad.py:17-20`` (ndim 20).  Tolerances, stated per test:

* float64 pieces (``Tangent``, one TGLS step): 1e-13 and 1e-12 absolute;
  only the summation order differs.
* float64 and twofloat integrations against JAX float64: the trajectory
  tolerance of ``tests/test_trajectory.py:57``, rtol 1e-9 and atol 1e-11,
  the atol scaled by ``max|M|`` for the fundamental matrices.
* double-float pieces against *eager* JAX double-float with
  ``accumulate='strict'`` (XLA:CPU under ``jit`` strips the EFT barriers):
  atol 1e-14, on the qgs_rp system only (eager JAX compiles every op, so
  MAOOAM would take minutes); on both systems against the port's float64
  pieces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgs_tpu.integrators.integrator import (
    RungeKuttaTglsIntegrator as JaxRungeKuttaTglsIntegrator,
)
from qgs_tpu.integrators.rk import integrate_runge_kutta as jax_integrate
from qgs_tpu.integrators.rk import (
    integrate_runge_kutta_tgls as jax_integrate_tgls,
)
from qgs_tpu.integrators.rk import make_tgls_step as jax_make_tgls_step
from qgs_tpu.integrators.rk import rk2_tableau as jax_rk2_tableau
from qgs_tpu.integrators.rk import rk4_tableau as jax_rk4_tableau
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu.ops import contraction as jcon
from qgs_tpu.ops import twofloat as jtf
from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.integrators.integrate import integrate_runge_kutta
from qgs_tpu_torch.integrators.integrator import (
    RungeKuttaTglsIntegrator, same_model_jacobian,
)
from qgs_tpu_torch.integrators.rk import (
    infer_ndim, integrate_runge_kutta_tgls, integrate_runge_kutta_tgls_df,
    make_tgls_step, rk2_tableau, rk4_tableau,
)
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops import contraction as con
from qgs_tpu_torch.ops import twofloat as tf

from tests.test_torch_host import both_params, maooam, tlad
from tests.test_torch_lyapunov import Df63, f63

TOL = dict(rtol=1e-9, atol=1e-11)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run tiny tensors: one intra-op thread.  Under the suite's
    parallel workers an OpenMP team in every worker oversubscribes the
    cores and makes them several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SYSTEMS = {"maooam": maooam, "tlad": tlad}


@pytest.fixture(scope="module", params=list(SYSTEMS))
def system(request):
    """Both packages' tendencies of one configuration (the port's on the
    CPU), and a state near the attractor from a JAX spin-up."""
    jax_pars, pars = both_params(SYSTEMS[request.param])
    f_j, Df_j, qgt_j = jax_create_tendencies(jax_pars, return_qgtensor=True)
    f_p, Df_p, qgt_p = create_tendencies(pars, return_qgtensor=True,
                                         device="cpu")
    ic = np.random.default_rng(42).random((3, pars.ndim)) * 0.01
    _, ic = jax_integrate(f_j.batched, 0., 200., 0.1, ic, write_steps=0)
    return dict(n=pars.ndim, f_j=f_j, Df_j=Df_j, qgt_j=qgt_j, f_p=f_p,
                Df_p=Df_p, qgt_p=qgt_p, ic=np.array(ic))


def _fmat_close(got, ref):
    """The fundamental-matrix tolerance: rtol 1e-9, atol 1e-11 max|M|."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL["rtol"],
                               atol=TOL["atol"] * max(np.abs(ref).max(), 1.0))


# ---------------------------------------------------------------------------
# the direct tangent contraction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "adjoint", "inverse"])
@pytest.mark.parametrize("maker", ["make_direct_tangent",
                                   "make_bucketed_tangent"])
def test_tangent_matches_jax(system, maker, variant):
    """``Tangent`` against both JAX constructors: atol 1e-13."""
    kw = {variant: True} if variant != "plain" else {}
    rng = np.random.default_rng(1)
    n = system["n"]
    xx = np.concatenate([np.ones((3, 1)), rng.random((3, n)) * 0.05], axis=1)
    dm = rng.standard_normal((3, n, 5))
    ref = jax.jit(getattr(jcon, maker)(system["qgt_j"].jacobian_tensor,
                                       **kw))(jnp.asarray(xx), jnp.asarray(dm))
    tg = getattr(con, maker)(system["qgt_p"].jacobian_tensor, device="cpu",
                             **kw)
    got = tg(torch.as_tensor(xx), torch.as_tensor(dm))
    assert got.shape == (3, n, 5) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-13)


def test_tangent_is_the_jacobian_product(system):
    """``Tangent`` is ``J dm``, ``J^T dm`` and ``-J dm`` of the port's own
    ``Jacobian``: atol 1e-13."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.random((2, system["n"])) * 0.05)
    dm = torch.as_tensor(rng.standard_normal((2, system["n"], 4)))
    J = system["Df_p"].batched(0., x)
    jt = system["qgt_p"].jacobian_tensor
    xx = con._with_dummy(x)
    for kw, ref in (({}, J @ dm), ({"adjoint": True}, J.mT @ dm),
                    ({"inverse": True}, -(J @ dm))):
        got = con.make_direct_tangent(jt, device="cpu", **kw)(xx, dm)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-13)


# ---------------------------------------------------------------------------
# one TGLS step and the integration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["fjac", "fjac_adjoint", "fjac_inverse",
                                   "tangent", "rk2"])
def test_tgls_step_matches_jax(system, route):
    """One coupled step of dt 0.1 from an identity tangent: atol 1e-12."""
    n = system["n"]
    y = system["ic"]
    dm = np.broadcast_to(np.eye(n), (3, n, n)).copy()
    kw = {"adjoint": True} if route == "fjac_adjoint" else (
        {"inverse": True} if route == "fjac_inverse" else {})
    tab_j = jax_rk2_tableau() if route == "rk2" else jax_rk4_tableau()
    tab_p = rk2_tableau() if route == "rk2" else rk4_tableau()
    tg_j = tg_p = None
    if route == "tangent":
        tg_j = jcon.make_direct_tangent(system["qgt_j"].jacobian_tensor)
        tg_p = con.make_direct_tangent(system["qgt_p"].jacobian_tensor,
                                       device="cpu")
    step_j = jax_make_tgls_step(system["f_j"].batched, system["Df_j"].batched,
                                *tab_j, tangent=tg_j, **kw)
    step_p = make_tgls_step(system["f_p"].batched, system["Df_p"].batched,
                            *tab_p, tangent=tg_p, **kw)
    yj, mj = step_j((jnp.asarray(y), jnp.asarray(dm)), 0., 0.1)
    yp, mp = step_p((torch.as_tensor(y), torch.as_tensor(dm)), 0., 0.1)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(mp.numpy(), np.asarray(mj), rtol=0,
                               atol=1e-12)


def _boundary_j(t, x):
    return 0.01 * jnp.stack([x, x ** 2], axis=-1)


def _boundary_p(t, x):
    return 0.01 * torch.stack([x, x ** 2], dim=-1)


def _tg_ic(kind, B, n):
    rng = np.random.default_rng(3)
    return {"1d": rng.standard_normal(n),
            "per_trajectory": rng.standard_normal((B, n)),
            "matrix": rng.standard_normal((2, n)),
            "3d": rng.standard_normal((B, n, 2)),
            "3d_transposed": rng.standard_normal((B, 2, n))}[kind]


TGLS_CASES = {
    "1d_w7": dict(tg="1d", write_steps=7),
    "per_trajectory_w0": dict(tg="per_trajectory", write_steps=0),
    "matrix_w7_backward": dict(tg="matrix", write_steps=7, forward=False),
    "3d_w0_backward": dict(tg="3d", write_steps=0, forward=False),
    "3d_transposed_w7": dict(tg="3d_transposed", write_steps=7),
    "adjoint_w7": dict(tg="matrix", write_steps=7, adjoint=True),
    "inverse_w0": dict(tg="3d", write_steps=0, inverse=True),
    "boundary_w7": dict(tg="3d", write_steps=7, boundary=True),
}


@pytest.mark.parametrize("case", list(TGLS_CASES))
def test_integrate_tgls_matches_jax(system, case):
    """``integrate_runge_kutta_tgls`` over [0, 3.05] at dt 0.1 (a shorter
    last step) for every tangent-IC form, forward and backward, write_steps
    0 and 7, adjoint, inverse and a boundary term: equal record times,
    trajectory rtol 1e-9 / atol 1e-11, matrices atol 1e-11 max|M|."""
    kw = dict(TGLS_CASES[case])
    tg = _tg_ic(kw.pop("tg"), 3, system["n"])
    boundary = kw.pop("boundary", False)
    args = (0., 3.05, 0.1, system["ic"], tg)
    t_j, y_j, m_j = jax_integrate_tgls(
        system["f_j"].batched, system["Df_j"].batched, *args,
        boundary=_boundary_j if boundary else None, **kw)
    t_p, y_p, m_p = integrate_runge_kutta_tgls(
        system["f_p"].batched, system["Df_p"].batched, *args,
        boundary=_boundary_p if boundary else None, **kw)
    assert np.array_equal(t_p, t_j)
    assert tuple(y_p.shape) == np.shape(y_j)
    assert tuple(m_p.shape) == np.shape(m_j)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), **TOL)
    _fmat_close(m_p, m_j)


# ---------------------------------------------------------------------------
# tests/test_tlad.py, on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tlad_port():
    pars = tlad(QgParams)
    f, Df = create_tendencies(pars, device="cpu")
    ic = np.random.default_rng(42).random(pars.ndim) * 0.01
    _, ic = integrate_runge_kutta(f.batched, 0., 300., 0.1, ic,
                                  write_steps=0)
    return pars.ndim, f, Df, ic


def test_taylor(tlad_port):
    """TL correctness (``tests/test_tlad.py:38-54``): ``||M(x+d) -
    M(x)||^2 / ||TL.d||^2 - 1`` below ``d / 10`` over 11 halvings of d."""
    n, f, Df, y0 = tlad_port
    _, y1 = integrate_runge_kutta(f.batched, 0., 0.1, 0.1, y0, write_steps=0)
    for k in range(11):
        dy = torch.full_like(y0, 2. ** (-k) / np.sqrt(float(n)))
        _, y1p = integrate_runge_kutta(f.batched, 0., 0.1, 0.1, y0 + dy,
                                       write_steps=0)
        dy1 = y1p - y1
        _, _, dy1_tl = integrate_runge_kutta_tgls(
            f.batched, Df.batched, 0., 0.1, 0.1, ic=y0, tg_ic=dy,
            write_steps=0)
        ratio = float(dy1 @ dy1) / float(dy1_tl @ dy1_tl)
        assert abs(ratio - 1.) < float(dy[0]) / 10, (k, ratio)


def _adjoint_mismatch(f, Df, y0, n, dt, n_pairs=100, seed=3):
    """Max relative |<TL.x, y> - <x, AD.y>| over ``n_pairs`` random pairs
    of one step of ``dt``, all pairs in one block each way."""
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((n, n_pairs))
    dy_bis = rng.standard_normal((n, n_pairs))
    _, _, tl_x = integrate_runge_kutta_tgls(f.batched, Df.batched, 0., dt, dt,
                                            ic=y0, tg_ic=dy.T, write_steps=0)
    _, _, ad_y = integrate_runge_kutta_tgls(f.batched, Df.batched, 0., dt, dt,
                                            ic=y0, tg_ic=dy_bis.T,
                                            write_steps=0, adjoint=True)
    norm1 = np.einsum('np,np->p', tl_x.numpy(), dy_bis)
    norm2 = np.einsum('np,np->p', dy, ad_y.numpy())
    return np.max(np.abs(norm1 - norm2) / np.maximum(1.0, np.abs(norm1)))


def test_adjoint_identity(tlad_port):
    """``<TL.x, y> = <x, AD.y>`` over 100 pairs to the RK4 discretization
    error of the continuous adjoint (``tests/test_tlad.py:77-96``): below
    1e-3 at dt 0.1, and shrinking at an order above 2.5 when dt halves."""
    n, f, Df, y0 = tlad_port
    err_h = _adjoint_mismatch(f, Df, y0, n, 0.1)
    assert err_h < 1e-3, err_h
    err_h2 = _adjoint_mismatch(f, Df, y0, n, 0.05)
    assert np.log2(err_h / err_h2) > 2.5, (err_h, err_h2)


def test_fundamental_matrix_and_inverse(tlad_port):
    """The identity propagates to the resolvent M, whose columns are the TL
    of the basis vectors (``tests/test_tlad.py:129-143``: rtol 1e-10, atol
    1e-12); the inverse flag propagates with -J, so its resolvent is
    ``-M`` to first order in dt (atol 0.05 here)."""
    n, f, Df, y0 = tlad_port
    _, _, M = integrate_runge_kutta_tgls(f.batched, Df.batched, 0., 0.1, 0.1,
                                         ic=y0, tg_ic=np.eye(n),
                                         write_steps=0)
    assert M.shape == (n, n)
    e0 = np.zeros(n)
    e0[0] = 1.
    _, _, tl_e0 = integrate_runge_kutta_tgls(f.batched, Df.batched, 0., 0.1,
                                             0.1, ic=y0, tg_ic=e0,
                                             write_steps=0)
    torch.testing.assert_close(M[:, 0], tl_e0, rtol=1e-10, atol=1e-12)
    _, _, Mi = integrate_runge_kutta_tgls(f.batched, Df.batched, 0., 0.1,
                                          0.1, ic=y0, tg_ic=np.eye(n),
                                          write_steps=0, inverse=True)
    eye = torch.eye(n, dtype=M.dtype)
    torch.testing.assert_close(Mi - eye, -(M - eye), rtol=0, atol=0.05)


# ---------------------------------------------------------------------------
# twofloat
# ---------------------------------------------------------------------------

def _df_np(pair):
    return np.asarray(jtf.df_to_f64(pair))


@pytest.fixture(scope="module")
def rp_df():
    """The qgs_rp system's tensors in both packages, and a state near its
    attractor, for the eager double-float comparisons."""
    jax_pars, pars = both_params(tlad)
    f_j, _, qgt_j = jax_create_tendencies(jax_pars, return_qgtensor=True)
    _, _, qgt_p = create_tendencies(pars, return_qgtensor=True, device="cpu")
    ic = np.random.default_rng(42).random((2, pars.ndim)) * 0.01
    _, ic = jax_integrate(f_j.batched, 0., 200., 0.1, ic, write_steps=0)
    return pars.ndim, qgt_j, qgt_p, np.array(ic)


@pytest.mark.parametrize("variant", ["plain", "adjoint", "inverse"])
def test_df_tangent_matches_eager_jax(rp_df, variant):
    """``DfTangent`` against eager JAX ``make_df_tangent_contraction`` with
    ``accumulate='strict'``: atol 1e-14."""
    n, qgt_j, qgt_p, _ = rp_df
    kw = {variant: True} if variant != "plain" else {}
    rng = np.random.default_rng(4)
    xx = np.concatenate([np.ones((2, 1)), rng.random((2, n)) * 0.05], axis=1)
    dm = rng.standard_normal((2, n, 3))
    ref = jtf.make_df_tangent_contraction(
        qgt_j.jacobian_tensor, accumulate="strict", **kw)(
        jtf.df_from_f64(jnp.asarray(xx)), jtf.df_from_f64(jnp.asarray(dm)))
    tg = tf.make_df_tangent_contraction(qgt_p.jacobian_tensor, device="cpu",
                                        **kw)
    got = tg(tf.df_from_f64(torch.as_tensor(xx)),
             tf.df_from_f64(torch.as_tensor(dm)))
    assert got[0].dtype == torch.float32 and got[0].shape == (2, n, 3)
    np.testing.assert_allclose(tf.df_to_f64(got).numpy(), _df_np(ref),
                               rtol=0, atol=1e-14)


@pytest.mark.parametrize("variant", ["plain", "adjoint", "inverse"])
def test_df_tangent_matches_float64_tangent(system, variant):
    """``DfTangent`` against the port's float64 ``Tangent`` on the same
    inputs: atol 1e-14 (about 48 bits of mantissa)."""
    kw = {variant: True} if variant != "plain" else {}
    rng = np.random.default_rng(4)
    n = system["n"]
    xx = torch.as_tensor(np.concatenate(
        [np.ones((2, 1)), rng.random((2, n)) * 0.05], axis=1))
    dm = torch.as_tensor(rng.standard_normal((2, n, n)))
    jt = system["qgt_p"].jacobian_tensor
    ref = con.make_direct_tangent(jt, device="cpu", **kw)(xx, dm)
    got = tf.make_df_tangent_contraction(jt, device="cpu", **kw)(
        tf.df_from_f64(xx), tf.df_from_f64(dm))
    torch.testing.assert_close(tf.df_to_f64(got), ref, rtol=0, atol=1e-14)


def test_df_tangent_with_transform(system):
    """``with_transform`` composes: adjoint of adjoint is the plain
    contraction, bit for bit."""
    jt = system["qgt_p"].jacobian_tensor
    plain = tf.make_df_tangent_contraction(jt, device="cpu")
    twice = tf.make_df_tangent_contraction(jt, adjoint=True, inverse=True,
                                           device="cpu").with_transform(
        adjoint=True, inverse=True)
    assert plain.with_transform() is plain
    assert not twice.adjoint and not twice.inverse
    for name in ("vhi", "vlo", "idx_m", "idx_k"):
        assert torch.equal(getattr(plain, name), getattr(twice, name))


@pytest.mark.parametrize("form", ["rk4_dynamic", "rk4_baked", "rk2"])
def test_df_tgls_step_matches_eager_jax(rp_df, form):
    """One double-float TGLS step (dt 0.1, identity tangent) in each form
    against its eager JAX counterpart (``accumulate='strict'``): atol
    1e-14.  The baked form's ``dt / 6`` is not the dynamic form's."""
    n, qgt_j, qgt_p, y = rp_df
    T_j, JT_j = qgt_j.tensor, qgt_j.jacobian_tensor
    T_p, JT_p = qgt_p.tensor, qgt_p.jacobian_tensor
    f_df = tf.DfTendency(T_p.coords, T_p.data, T_p.shape, device="cpu")
    tg_df = tf.make_df_tangent_contraction(JT_p, device="cpu")
    dm = np.broadcast_to(np.eye(n), (2, n, n)).copy()
    cj = (jtf.df_from_f64(jnp.asarray(y)), jtf.df_from_f64(jnp.asarray(dm)))
    cp = (tf.df_from_f64(torch.as_tensor(y)),
          tf.df_from_f64(torch.as_tensor(dm)))
    if form == "rk4_dynamic":
        rj = jtf.make_df_tgls_rk4_step_dynamic(T_j, JT_j, accumulate="strict")(
            cj, 0., 0.1)
        rp = tf.make_df_tgls_rk4_step_dynamic(f_df, tg_df)(cp, 0., 0.1)
    elif form == "rk4_baked":
        rj = jtf.make_df_tgls_rk4_step(T_j, JT_j, 0.1, accumulate="strict")(cj)
        rp = tf.make_df_tgls_rk4_step(f_df, tg_df, 0.1, "cpu")(cp)
    else:
        rj = jtf.make_df_tgls_rk_step_dynamic(T_j, JT_j, *jax_rk2_tableau(),
                                              accumulate="strict")(cj, 0., .1)
        rp = tf.make_df_tgls_rk_step_dynamic(f_df, tg_df, *rk2_tableau())(
            cp, 0., 0.1)
    for got, ref in zip(rp, rj):
        np.testing.assert_allclose(tf.df_to_f64(got).numpy(), _df_np(ref),
                                   rtol=0, atol=1e-14)


def test_df_rk4_baked_step_matches_eager_jax(rp_df):
    """The baked double-float RK4 trajectory step (the forward pass of the
    twofloat forward vectors): atol 1e-14 after 10 steps."""
    _, qgt_j, qgt_p, y = rp_df
    T_p = qgt_p.tensor
    step_j = jtf.make_df_rk4_step(qgt_j.tensor, 0.1, accumulate="strict")
    step_p = tf.make_df_rk4_step(
        tf.DfTendency(T_p.coords, T_p.data, T_p.shape, device="cpu"), 0.1,
        "cpu")
    yj = jtf.df_from_f64(jnp.asarray(y))
    yp = tf.df_from_f64(torch.as_tensor(y))
    for _ in range(10):
        yj, yp = step_j(yj), step_p(yp)
    np.testing.assert_allclose(tf.df_to_f64(yp).numpy(), _df_np(yj), rtol=0,
                               atol=1e-14)


DF_CASES = {
    "forward_w7": dict(write_steps=7),
    "backward_w0": dict(write_steps=0, forward=False),
    "adjoint_w7": dict(write_steps=7, adjoint=True),
    "inverse_rk2_w0": dict(write_steps=0, inverse=True, rk2=True),
}


@pytest.mark.parametrize("case", list(DF_CASES))
def test_integrate_tgls_df_matches_jax_float64(system, case):
    """``integrate_runge_kutta_tgls_df`` over [0, 3.05] at dt 0.1 against
    JAX float64 TGLS: trajectory rtol 1e-9 / atol 1e-11, matrices atol
    1e-11 max|M|."""
    kw = dict(DF_CASES[case])
    tab = {}
    if kw.pop("rk2", False):
        tab_j = dict(zip("abc", jax_rk2_tableau()))
        tab = dict(zip("abc", rk2_tableau()))
    else:
        tab_j = {}
    n = system["n"]
    args = (0., 3.05, 0.1, system["ic"], np.eye(n))
    t_j, y_j, m_j = jax_integrate_tgls(system["f_j"].batched,
                                       system["Df_j"].batched, *args, **kw,
                                       **tab_j)
    T_p, JT_p = system["qgt_p"].tensor, system["qgt_p"].jacobian_tensor
    t_p, y_p, m_p = integrate_runge_kutta_tgls_df(
        tf.DfTendency(T_p.coords, T_p.data, T_p.shape, device="cpu"),
        tf.make_df_tangent_contraction(JT_p, device="cpu"), *args, **kw,
        **tab)
    assert np.array_equal(t_p, t_j)
    assert y_p.dtype == m_p.dtype == torch.float64
    assert tuple(m_p.shape) == np.shape(m_j)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), **TOL)
    _fmat_close(m_p, m_j)


# ---------------------------------------------------------------------------
# RungeKuttaTglsIntegrator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["float64", "twofloat"])
def test_tgls_integrator_matches_jax(system, precision):
    """The integrator in both precisions against the JAX float64 one, with
    a stored tangent IC and the adjoint: trajectory rtol 1e-9 / atol 1e-11,
    matrices atol 1e-11 max|M|."""
    n = system["n"]
    tg = np.random.default_rng(5).standard_normal((3, n, 4))
    ij = JaxRungeKuttaTglsIntegrator()
    ij.set_func(system["f_j"], system["Df_j"])
    ij.set_tg_ic(tg)
    ij.integrate(0., 2., 0.1, ic=system["ic"], write_steps=4, adjoint=True)
    ip = RungeKuttaTglsIntegrator(precision=precision)
    ip.set_func(system["f_p"], system["Df_p"])
    ip.set_tg_ic(tg)
    assert np.array_equal(ip.get_tg_ic(), tg)
    ip.integrate(0., 2., 0.1, ic=system["ic"], write_steps=4, adjoint=True)
    (t_j, y_j, m_j), (t_p, y_p, m_p) = (ij.get_trajectories(),
                                        ip.get_trajectories())
    assert np.array_equal(t_p, t_j)
    assert y_p.device.type == "cpu" and y_p.dtype == torch.float64
    assert tuple(m_p.shape) == np.shape(m_j) == (3, n, 4, 6)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), **TOL)
    _fmat_close(m_p, m_j)

    # a single state squeezes, and the default tangent IC is the identity
    ip.tg_ic = None
    ip.integrate(0., 0.5, 0.1, ic=system["ic"][0], write_steps=0)
    _, y1, m1 = ip.get_trajectories()
    assert tuple(y1.shape) == (n,) and tuple(m1.shape) == (n, n)


def test_tgls_integrator_errors(system):
    """The twofloat tier refuses a custom Jacobian and a boundary term, and
    keeps the tensors for a same-model Jacobian rebuilt from the same
    parameters."""
    ic = system["ic"]
    custom = RungeKuttaTglsIntegrator(precision="twofloat")
    custom.set_func(system["f_p"], lambda t, x: system["Df_p"].batched(t, x))
    with pytest.raises(RuntimeError, match="same model"):
        custom.integrate(0., 0.2, 0.1, ic=ic)

    ip = RungeKuttaTglsIntegrator(precision="twofloat")
    ip.set_func(system["f_p"], system["Df_p"])
    with pytest.raises(ValueError, match="boundary"):
        ip.integrate(0., 0.2, 0.1, ic=ic, boundary=_boundary_p)

    unset = RungeKuttaTglsIntegrator()
    unset.set_func(system["f_p"])
    with pytest.raises(RuntimeError, match="set_func"):
        unset.integrate(0., 0.2, 0.1, ic=ic)

    other_f, other_Df = create_tendencies(
        tlad(QgParams) if system["n"] == 20 else maooam(QgParams),
        device="cpu")
    assert same_model_jacobian(other_Df, system["qgt_p"])
    assert not same_model_jacobian(lambda t, x: x, system["qgt_p"])


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["integrate_runge_kutta", "infer_ndim",
                                   "integrate_runge_kutta_tgls",
                                   "RungeKuttaTglsIntegrator"])
def test_plain_callable_runs_on_the_card_unless_asked(entry):
    """A function that carries no device, with a NumPy ``ic``, runs on
    ``"cuda"``: here, without a card, PyTorch raises; with
    ``device="cpu"`` it runs on the CPU."""
    ic = np.array([[1., 1., 1.]])

    def call(device):
        if entry == "integrate_runge_kutta":
            return integrate_runge_kutta(f63, 0., 0.1, 0.01, ic,
                                         device=device)[1]
        if entry == "infer_ndim":
            return infer_ndim(f63, device)
        if entry == "integrate_runge_kutta_tgls":
            return integrate_runge_kutta_tgls(f63, Df63, 0., 0.1, 0.01,
                                              ic, np.eye(3),
                                              device=device)[2]
        integ = RungeKuttaTglsIntegrator(device=device)
        integ.set_func(f63, Df63)
        integ.integrate(0., 0.1, 0.01, ic=ic)
        return integ.get_trajectories()[2]

    out = call("cpu")
    assert out == 3 if entry == "infer_ndim" else out.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            call(None)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float64", "twofloat"])
def test_tgls_on_card_matches_cpu(cuda_device, precision):
    """The TGLS integrator on the card against the same call on the CPU,
    MAOOAM B=8, 100 steps: rtol 1e-9 / atol 1e-11 max|M|."""
    pars = maooam(QgParams)
    ic = np.random.default_rng(6).random((8, pars.ndim)) * 0.01
    out = {}
    for device in ("cpu", cuda_device):
        f, Df = create_tendencies(pars, device=device)
        integ = RungeKuttaTglsIntegrator(precision=precision)
        integ.set_func(f, Df)
        integ.integrate(0., 10., 0.1, ic=ic, write_steps=25)
        out[str(device)] = integ.get_trajectories()
    _, y_c, m_c = out["cpu"]
    _, y_g, m_g = out[str(cuda_device)]
    assert y_g.device.type == "cuda"
    np.testing.assert_allclose(y_g.cpu().numpy(), y_c.numpy(), **TOL)
    _fmat_close(m_g.cpu(), m_c.numpy())
