"""The port's Lyapunov toolbox against the JAX package's on the CPU
(``device="cpu"``), with the tolerance of each test in its docstring.

* Lorenz-63, whose spectrum is known, (0.906, 0, -14.57): torch ``f63`` /
  ``Df63`` against the JAX ones of ``tests/test_lyapunov.py`` on the same
  ``ic`` and ``seed``, on spans short enough (t <= 4, lambda_1 about 0.9)
  that the trajectories stay glued: exponents at 1e-9, vectors up to column
  sign at 1e-9.  On one longer span, the spectrum at the tolerances of
  ``tests/test_lyapunov.py``.
* The twofloat toolbox on the qgs_rp system against JAX float64, at the
  thresholds of ``tests/test_lyapunov.py:340-424``.  The port's Ginelli
  backward pass solves in native float64 in both modes, where the JAX
  twofloat pass uses ``trisolve_mp``.
"""

import numpy as np
import pytest
import torch

from qgs_tpu.integrators.rk import integrate_runge_kutta as jax_integrate
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu.toolbox import lyapunov as jl
from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.integrators.integrator import (
    RungeKuttaIntegrator, RungeKuttaTglsIntegrator,
)
from qgs_tpu_torch.integrators.rk import rk4_tableau
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops import fused_df_rk4, fused_rk4
from qgs_tpu_torch.ops.twofloat import DfTendency, df_from_f64, df_to_f64
from qgs_tpu_torch.toolbox import lyapunov as pl

from tests.test_lyapunov import Df63 as jax_Df63
from tests.test_lyapunov import f63 as jax_f63
from tests.test_torch_host import both_params, maooam, tlad

SIGMA, RHO, BETA = 10., 28., 8. / 3.
L63_SPECTRUM = np.array([0.906, 0.0, -14.572])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run tiny tensors: one intra-op thread.  Under the suite's
    parallel workers an OpenMP team in every worker oversubscribes the
    cores and makes them several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f63(t, x):
    return torch.stack([SIGMA * (x[:, 1] - x[:, 0]),
                        RHO * x[:, 0] - x[:, 1] - x[:, 0] * x[:, 2],
                        x[:, 0] * x[:, 1] - BETA * x[:, 2]], dim=1)


def Df63(t, x):
    z = torch.zeros_like(x[:, 0])
    o = torch.ones_like(z)
    return torch.stack([
        torch.stack([-SIGMA * o, SIGMA * o, z], dim=1),
        torch.stack([RHO - x[:, 2], -o, -x[:, 0]], dim=1),
        torch.stack([x[:, 1], x[:, 0], -BETA * o], dim=1),
    ], dim=1)


@pytest.fixture(scope="module")
def attractor_ic():
    ic = np.array([[1., 1., 1.], [-3., 2., 20.]])
    _, y = jax_integrate(jax_f63, 0., 50., 0.01, ic, write_steps=0)
    return np.array(y)


def _same_up_to_sign(got, ref, atol):
    """Vectors (..., n, n_vec[, T]) equal up to each column's sign."""
    got, ref = got.numpy(), np.asarray(ref)
    axis = -3 if ref.ndim >= 3 else 0
    sign = np.sign(np.sum(got * ref, axis=axis, keepdims=True))
    np.testing.assert_allclose(got * sign, ref, rtol=0, atol=atol)


L63_CASES = {
    "backward": ("compute_backward_lyapunovs", (0., 1., 4.), slice(None)),
    "forward": ("compute_forward_lyapunovs", (0., 3., 4.), slice(None)),
    "ginelli": ("compute_clvs_ginelli", (0., 1., 3., 4.), slice(0, 1)),
    "subspace": ("compute_clvs_subspace", (0., 1., 3., 4.), slice(0, 1)),
}


@pytest.mark.parametrize("write_steps", [10, 0])
@pytest.mark.parametrize("case", list(L63_CASES))
def test_l63_matches_jax(attractor_ic, case, write_steps):
    """Every ``compute_*`` on Lorenz-63 at dt = mdt = 0.01 against JAX:
    equal times, trajectory and exponents atol 1e-9, vectors up to column
    sign atol 1e-9."""
    name, span, members = L63_CASES[case]
    args = span + (0.01, 0.01, attractor_ic[members])
    t_j, y_j, e_j, v_j = getattr(jl, name)(jax_f63, jax_Df63, *args,
                                          write_steps=write_steps)
    t_p, y_p, e_p, v_p = getattr(pl, name)(f63, Df63, *args,
                                          write_steps=write_steps,
                                          device="cpu")
    assert np.array_equal(t_p, t_j)
    for got, ref in ((y_p, y_j), (e_p, e_j), (v_p, v_j)):
        assert tuple(got.shape) == np.shape(ref)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(e_p.numpy(), np.asarray(e_j), rtol=0,
                               atol=1e-9)
    _same_up_to_sign(v_p, v_j, 1e-9)


def test_l63_spectrum(attractor_ic):
    """The known spectrum over 50 time units of backward vectors
    (``tests/test_lyapunov.py:43-53``: atol 0.35, exponent sum within 0.3
    of the divergence -(sigma + 1 + beta)); the vectors orthonormal to
    1e-10."""
    _, _, exps, vecs = pl.compute_backward_lyapunovs(
        f63, Df63, 0., 10., 60., 0.01, 0.01, attractor_ic, device="cpu")
    mean = exps.mean(dim=-1).numpy()
    for b in range(2):
        np.testing.assert_allclose(mean[b], L63_SPECTRUM, atol=0.35)
    assert abs(mean[0].sum() + (SIGMA + 1 + BETA)) < 0.3
    v = vecs[0, :, :, -1]
    torch.testing.assert_close(v.T @ v, torch.eye(3, dtype=v.dtype),
                               rtol=0, atol=1e-10)


def test_ginelli_clvs_unit_and_aligned(attractor_ic):
    """Ginelli CLVs are unit vectors (atol 1e-8) and the leading one aligns
    with the leading backward vector (``|dot| > 1 - 1e-6``,
    ``tests/test_lyapunov.py:66-79``)."""
    ic = attractor_ic[:1]
    _, _, _, v = pl.compute_clvs_ginelli(f63, Df63, 0., 10., 20., 30., 0.01,
                                         0.01, ic, device="cpu")
    _, _, _, bv = pl.compute_backward_lyapunovs(f63, Df63, 0., 10., 20.,
                                                0.01, 0.01, ic, device="cpu")
    norms = torch.linalg.norm(v, dim=0)
    torch.testing.assert_close(norms, torch.ones_like(norms), rtol=0,
                               atol=1e-8)
    dots = torch.abs(torch.sum(v[:, 0] * bv[:, 0], dim=0))
    assert float(dots.min()) > 1 - 1e-6


# ---------------------------------------------------------------------------
# the twofloat toolbox on the qgs_rp system
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rp_system():
    """The qgs_rp system of ``tests/test_lyapunov.py:352-362`` in both
    packages (the port's on the CPU) and a state on its attractor."""
    jax_pars, pars = both_params(tlad)
    f_j, Df_j, qgt_j = jax_create_tendencies(jax_pars, return_qgtensor=True)
    f_p, Df_p, qgt = create_tendencies(pars, return_qgtensor=True,
                                       device="cpu")
    ic = np.random.default_rng(0).random((1, pars.ndim)) * 0.01
    _, ic = jax_integrate(f_j.batched, 0., 3000., 0.1, ic, write_steps=0)
    return dict(f_j=f_j, Df_j=Df_j, f_p=f_p, Df_p=Df_p,
                tensors=(qgt.tensor, qgt.jacobian_tensor),
                tensors_j=(qgt_j.tensor, qgt_j.jacobian_tensor),
                ic=np.atleast_2d(np.array(ic)), n=pars.ndim)


def test_twofloat_blv_matches_jax_float64(rp_system):
    """Twofloat backward exponents over (0, 10, 40) against JAX float64:
    mean exponents within 5e-8 (``tests/test_lyapunov.py:380``), float64
    exponents, vectors orthonormal to 1e-12, and the same numbers through
    ``LyapunovsEstimator(precision='twofloat')`` (atol 1e-12)."""
    s = rp_system
    args = (0., 10., 40., 0.1, 0.1, s["ic"])
    _, _, e64, _ = jl.compute_backward_lyapunovs(
        s["f_j"].batched, s["Df_j"].batched, *args, write_steps=1)
    _, _, edf, vdf = pl.compute_backward_lyapunovs(
        s["f_p"].batched, s["Df_p"].batched, *args, write_steps=1,
        precision="twofloat", tensors=s["tensors"], device="cpu")
    assert edf.dtype == torch.float64
    mdf = edf.mean(dim=-1).numpy()
    assert np.abs(np.asarray(e64).mean(-1) - mdf).max() < 5e-8
    v = vdf[..., -1]
    assert float((v.T @ v - torch.eye(s["n"], dtype=v.dtype)).abs().max()) \
        < 1e-12

    est = pl.LyapunovsEstimator(precision="twofloat")
    est.set_func(s["f_p"], s["Df_p"])
    est.compute_lyapunovs(*args, write_steps=1)
    out = est.get_lyapunovs()
    assert all(isinstance(a, np.ndarray) for a in out[1:])
    np.testing.assert_allclose(out[2].mean(-1), mdf, rtol=0, atol=1e-12)


def test_twofloat_flv_and_ginelli_match_jax_float64(rp_system):
    """Twofloat forward exponents over (0, 30, 40) and Ginelli exponents
    over (0, 10, 25, 40) against JAX float64: mean exponents within 1e-6,
    the CLVs aligned column by column above 1 - 1e-8
    (``tests/test_lyapunov.py:391-409``).

    The port's twofloat Ginelli backward pass solves in native float64: its
    exponents match JAX float64 record by record within 1e-12 (1.2e-13 here,
    on the CPU).  JAX's own twofloat pass (``trisolve_mp``, and the EFT
    barriers stripped under ``jit`` on the CPU) lies 7.8e-8 from both, so
    the port is held against it only at that gap (1e-7)."""
    s = rp_system
    f_j, Df_j = s["f_j"].batched, s["Df_j"].batched
    f_p, Df_p = s["f_p"].batched, s["Df_p"].batched
    df = dict(precision="twofloat", tensors=s["tensors"], device="cpu")
    _, _, fe64, _ = jl.compute_forward_lyapunovs(f_j, Df_j, 0., 30., 40.,
                                                 0.1, 0.1, s["ic"])
    _, _, fedf, _ = pl.compute_forward_lyapunovs(f_p, Df_p, 0., 30., 40.,
                                                 0.1, 0.1, s["ic"], **df)
    assert np.abs(np.asarray(fe64).mean(-1)
                  - fedf.mean(dim=-1).numpy()).max() < 1e-6

    _, _, ge64, gv64 = jl.compute_clvs_ginelli(f_j, Df_j, 0., 10., 25., 40.,
                                               0.1, 0.1, s["ic"])
    _, _, gedf, gvdf = pl.compute_clvs_ginelli(f_p, Df_p, 0., 10., 25., 40.,
                                               0.1, 0.1, s["ic"], **df)
    assert np.abs(np.asarray(ge64).mean(-1)
                  - gedf.mean(dim=-1).numpy()).max() < 1e-6
    np.testing.assert_allclose(gedf.numpy(), np.asarray(ge64), rtol=0,
                               atol=1e-12)
    _, _, ge_jdf, _ = jl.compute_clvs_ginelli(
        f_j, Df_j, 0., 10., 25., 40., 0.1, 0.1, s["ic"],
        precision="twofloat", tensors=s["tensors_j"])
    np.testing.assert_allclose(gedf.numpy(), np.asarray(ge_jdf), rtol=0,
                               atol=1e-7)
    align = np.abs(np.einsum('nvt,nvt->vt', np.asarray(gv64), gvdf.numpy()))
    assert align.min() > 1 - 1e-8, align.min()


def test_twofloat_needs_the_tensors(rp_system):
    s = rp_system
    with pytest.raises(ValueError, match="tensors"):
        pl.compute_backward_lyapunovs(s["f_p"].batched, s["Df_p"].batched,
                                      0., 0.1, 0.2, 0.1, 0.1, s["ic"],
                                      precision="twofloat", device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        pl.LyapunovsEstimator(precision="float32")


# ---------------------------------------------------------------------------
# estimators, options, QR
# ---------------------------------------------------------------------------

def test_estimators_match_the_functions(attractor_ic):
    """The estimator classes return NumPy arrays equal, bit for bit, to the
    functions' tensors (``device="cpu"`` on the estimator), and the CLV
    estimator's subspace method returns the BLVs and FLVs it was asked
    for."""
    ic = attractor_ic[0]
    est = pl.LyapunovsEstimator(device="cpu")
    est.set_func(f63, Df63)
    est.compute_lyapunovs(0., 1., 3., 0.01, 0.01, ic, write_steps=5,
                          forward=True)
    t, traj, exps, vecs = est.get_lyapunovs()
    ref = pl.compute_forward_lyapunovs(f63, Df63, 0., 1., 3., 0.01, 0.01, ic,
                                       write_steps=5, device="cpu")
    assert np.array_equal(t, ref[0])
    for got, want in zip((traj, exps, vecs), ref[1:]):
        assert isinstance(got, np.ndarray)
        assert np.array_equal(got, want.numpy())

    cest = pl.CovariantLyapunovsEstimator(device="cpu")
    cest.set_func(f63, Df63)
    cest.compute_clvs(0., 1., 2., 3., 0.01, 0.01, ic, write_steps=5,
                      method=1, backward_vectors=True)
    assert cest.get_flvs() is None
    t, traj, bexp, bvec = cest.get_blvs()
    assert bvec.shape == (3, 3, 21) and np.isfinite(bexp).all()
    assert np.isfinite(cest.get_clvs()[2]).all()


def test_partial_tableau_and_custom_fjac(attractor_ic, rp_system):
    """Partial ``b`` merges with the RK4 defaults in every estimator and
    integrator and changes the result (``tests/test_lyapunov.py:125-174``);
    a custom ``fjac`` keeps the tensors out, a same-model one keeps them
    (``tests/test_lyapunov.py:509-552``)."""
    a4, _, c4 = rk4_tableau()
    b_euler = np.array([1., 0., 0., 0.])
    for cls in (pl.LyapunovsEstimator, pl.CovariantLyapunovsEstimator):
        est = cls(b=b_euler)
        assert np.array_equal(est.tableau[1], b_euler)
        assert np.array_equal(est.tableau[0], a4)
        est.set_bca(c=c4)
        assert np.array_equal(est.tableau[1], b_euler)
        est2 = cls()
        est2.set_bca(b=b_euler)
        assert np.array_equal(est2.tableau[1], b_euler)
    for icls in (RungeKuttaIntegrator, RungeKuttaTglsIntegrator):
        integ = icls(b=b_euler)
        assert np.array_equal(integ.b, b_euler)
        integ.set_bca(c=c4)
        assert np.array_equal(integ.b, b_euler)

    ic = attractor_ic[0]
    runs = []
    for b in (None, b_euler):
        est = pl.LyapunovsEstimator(b=b, device="cpu")
        est.set_func(f63, Df63)
        est.compute_lyapunovs(0., 1., 2., 0.01, 0.01, ic)
        runs.append(est.get_lyapunovs()[1])
    assert not np.allclose(*runs)

    s = rp_system
    custom = pl.LyapunovsEstimator()
    custom.set_func(s["f_p"], lambda t, x: 0.5 * s["Df_p"].batched(t, x))
    assert custom._tensors is None
    same = pl.LyapunovsEstimator()
    same.set_func(s["f_p"], s["Df_p"])
    assert same._tensors is not None


def test_ginelli_noise_pert(attractor_ic):
    """``noise_pert=0`` is bit for bit no noise; a nonzero amplitude
    perturbs the vectors and leaves the exponents within 0.2
    (``tests/test_lyapunov.py:234-252``); the estimator passes it on."""
    args = (f63, Df63, 0., 2., 6., 8., 0.01, 0.01, attractor_ic[:1])
    _, _, e0, v0 = pl.compute_clvs_ginelli(*args, device="cpu")
    _, _, e0b, v0b = pl.compute_clvs_ginelli(*args, noise_pert=0.0,
                                             device="cpu")
    assert torch.equal(v0, v0b) and torch.equal(e0, e0b)
    _, _, e1, v1 = pl.compute_clvs_ginelli(*args, noise_pert=1e-3,
                                           device="cpu")
    assert not torch.equal(v0, v1)
    np.testing.assert_allclose(np.sort(e1.mean(-1).numpy()),
                               np.sort(e0.mean(-1).numpy()), atol=0.2)
    cest = pl.CovariantLyapunovsEstimator(noise_pert=1e-3, device="cpu")
    cest.set_func(f63, Df63)
    cest.set_noise_pert(0.0)
    cest.compute_clvs(*args[2:])
    assert np.array_equal(cest.get_clvs()[3], v0.numpy())


def test_float32_stays_float32(attractor_ic):
    """A float32 ensemble stays float32 end to end
    (``tests/test_lyapunov.py:213-231``: spectrum atol 0.5)."""
    ic32 = np.asarray(attractor_ic, np.float32)
    _, traj, exps, vecs = pl.compute_backward_lyapunovs(
        f63, Df63, 0., 10., 40., 0.01, 0.01, ic32, device="cpu")
    assert traj.dtype == exps.dtype == vecs.dtype == torch.float32
    np.testing.assert_allclose(exps.double().mean(-1)[0].numpy(),
                               L63_SPECTRUM, atol=0.5)
    _, _, sexp, svec = pl.compute_clvs_subspace(
        f63, Df63, 0., 2., 4., 6., 0.01, 0.01, ic32[:1], device="cpu")
    assert sexp.dtype == svec.dtype == torch.float32


def test_batched_qr_cholqr2_matches_householder():
    """CholeskyQR2 against Householder (``tests/test_lyapunov.py:426-447``):
    Q orthonormal to 1e-12, QR = M to 1e-9, |diag R| to 1e-10 relative; an
    unknown method and ``qr_method='mixed'`` raise."""
    rng = np.random.default_rng(0)
    m = torch.as_tensor(rng.standard_normal((8, 20, 12))
                        * np.logspace(0, 3, 12))
    qc, rc = pl.batched_qr(m, "cholqr2")
    qh, rh = pl.batched_qr(m, "householder")
    eye = torch.eye(12, dtype=m.dtype)
    assert float((qc.mT @ qc - eye).abs().max()) < 1e-12
    assert float((qc @ rc - m).abs().max()) < 1e-9
    ratio = (torch.diagonal(rc, dim1=-2, dim2=-1).abs()
             / torch.diagonal(rh, dim1=-2, dim2=-1).abs())
    assert float((ratio - 1).abs().max()) < 1e-10
    with pytest.raises(ValueError, match="unknown QR method"):
        pl.batched_qr(m, "givens")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pl.make_window_step_df(None, None, 0.1, 0.1, qr_method="mixed")


def test_window_spans_must_divide():
    with pytest.raises(ValueError, match="multiple of dt"):
        pl._n_windows(0., 1.05, 0.1)
    with pytest.raises(ValueError, match="multiple of mdt"):
        pl._n_sub(0.1, 0.03)


def test_plain_callable_runs_on_the_card_unless_asked(attractor_ic):
    """Without ``device``, a plain callable and a NumPy ``ic`` run on
    ``"cuda"``: here PyTorch raises; with ``device="cpu"`` the result lies
    on the CPU."""
    args = (f63, Df63, 0., 0.01, 0.02, 0.01, 0.01, attractor_ic)
    out = pl.compute_backward_lyapunovs(*args, device="cpu")
    assert out[1].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            pl.compute_backward_lyapunovs(*args)


def test_forward_pass_plain_route_on_cpu():
    """On the CPU the forward pass is the plain step loop (no kernel
    launch), in float64 and in double-float, and the double-float states
    agree with the float64 ones to 1e-12."""
    pars = maooam(QgParams)
    f, _, qgt = create_tendencies(pars, return_qgtensor=True, device="cpu")
    T = qgt.tensor
    y = torch.as_tensor(np.random.default_rng(1).random((2, pars.ndim))
                        * 0.01)
    before = (fused_rk4.launches, fused_df_rk4.launches)
    ys = pl.forward_boundary_states(f.batched, y, 3, 4, 0.1)
    ydf = pl.forward_boundary_states(
        DfTendency(T.coords, T.data, T.shape, device="cpu"), df_from_f64(y),
        3, 4, 0.1)
    assert (fused_rk4.launches, fused_df_rk4.launches) == before
    assert ys.shape == (4, 2, pars.ndim) and torch.equal(ys[0], y)
    torch.testing.assert_close(df_to_f64(ydf), ys, rtol=0, atol=1e-12)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused RK4 kernels have no CPU "
                    "build")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float64", "twofloat"])
def test_flv_kernel_route_matches_plain_route(cuda_device, precision):
    """The forward pass of the forward vectors on the card, one kernel
    launch, against its plain route (a function that carries no tensor):
    states atol 1e-9, and the whole forward exponents atol 1e-9."""
    pars = maooam(QgParams)
    f, Df, qgt = create_tendencies(pars, return_qgtensor=True,
                                   device=cuda_device)
    y = torch.as_tensor(np.random.default_rng(2).random((4, pars.ndim))
                        * 0.01, device=cuda_device)
    if precision == "twofloat":
        T = qgt.tensor
        fk = DfTendency(T.coords, T.data, T.shape, device=cuda_device)
        y, launches = df_from_f64(y), fused_df_rk4
        fp, conv = (lambda h, lo: fk(h, lo)), df_to_f64
    else:
        fk, launches, conv = f.batched, fused_rk4, (lambda x: x)
        fp = (lambda t, x: fk(t, x))
    before = launches.launches
    yk = pl.forward_boundary_states(fk, y, 20, 2, 0.1)
    assert launches.launches == before + 1
    yp = pl.forward_boundary_states(fp, y, 20, 2, 0.1)
    torch.testing.assert_close(conv(yk), conv(yp), rtol=0, atol=1e-9)
    if precision == "twofloat":      # the twofloat tier runs the tensors
        return
    kw = dict(tensors=(qgt.tensor, qgt.jacobian_tensor))
    _, _, ek, _ = pl.compute_forward_lyapunovs(
        f.batched, Df.batched, 0., 2., 4., 0.1, 0.1, y, **kw)
    _, _, ep, _ = pl.compute_forward_lyapunovs(
        fp, Df.batched, 0., 2., 4., 0.1, 0.1, y, **kw)
    torch.testing.assert_close(ek, ep, rtol=0, atol=1e-9)
