"""The port's rank-5 models (the T4 and dynamic-T radiation schemes, ndim
38) against the JAX package's on the CPU: the same numpy-seeded inputs
through ``qgs_tpu`` and ``qgs_tpu_torch`` (``device="cpu"``).  Tolerances,
stated per test:

* ``f`` and ``Df`` against ``qgs_tpu``'s ``make_tendency_fns`` and its
  reference-order NumPy backend: rtol 1e-10, atol 1e-12
  (``tests/test_t4.py:58-82``); the direct tangent against ``J dm``: 1e-11
  (``tests/test_t4.py:116-136``).
* float64 trajectories against the JAX float64 integrator: rtol 1e-9, atol
  1e-11 (``tests/test_trajectory.py:57``); twofloat against float64: 1e-9
  on trajectories, 1e-8 on fundamental matrices (``tests/test_t4.py:139-195``);
  backward Lyapunov exponents against JAX: 1e-9.

Also: the two-level layout's bound on T4, the analytic-blocks error, the
dimension probe (no call on a module that carries its tensor) and the
routing of rank-5 models: to K5 on the card in float64 and float32, to the
plain step loop otherwise.  On a CUDA card (marked ``cuda``): K5's
``integrate`` against the JAX float64 integrator, within 1e-12 of the
largest |value|."""

import numpy as np
import pytest
import torch

from qgs_tpu.integrators.rk import integrate_runge_kutta as jax_integrate
from qgs_tpu.models.numpy_backend import make_numpy_tendencies
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu.toolbox import lyapunov as jl
from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.integrators.integrator import (RungeKuttaIntegrator,
                                                  RungeKuttaTglsIntegrator)
from qgs_tpu_torch.integrators.rk import fused_route, infer_ndim
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops import contraction as con
from qgs_tpu_torch.ops import twofloat as tf
from qgs_tpu_torch.ops.fused_df_rk4 import DF
from qgs_tpu_torch.ops.fused_rk4 import K1
from qgs_tpu_torch.ops.fused_rk4_quartic import K5
from qgs_tpu_torch.toolbox import lyapunov as pl

from tests.test_torch_host import both_params, dynamic_t, maooam, t4

F_TOL = dict(rtol=1e-10, atol=1e-12)
TRAJ_TOL = dict(rtol=1e-9, atol=1e-11)

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run small tensors: one intra-op thread.  Under the
    suite's parallel workers an OpenMP team in every worker oversubscribes
    the cores and makes them several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SYSTEMS = {"t4": t4, "dynT": dynamic_t}


@pytest.fixture(scope="module", params=list(SYSTEMS))
def system(request):
    """Both packages' tendencies of one rank-5 configuration (the port's on
    the CPU; quadrature inner products built once a file), and states near
    the reference's stationary temperatures (``tests/test_t4.py:152-156``)."""
    jax_pars, pars = both_params(SYSTEMS[request.param])
    f_j, Df_j, qgt_j = jax_create_tendencies(jax_pars, return_qgtensor=True)
    f_p, Df_p, qgt_p = create_tendencies(pars, return_qgtensor=True,
                                         device="cpu")
    x0 = np.random.default_rng(7).random((2, pars.ndim)) * 0.01
    vr = pars.variables_range
    x0[:, vr[0]] = 0.1
    x0[:, vr[2]] = 0.12
    return dict(name=request.param, n=pars.ndim, pars=pars, f_j=f_j,
                Df_j=Df_j, qgt_j=qgt_j, f_p=f_p, Df_p=Df_p, qgt_p=qgt_p,
                x0=x0)


def test_tensors_are_rank5(system):
    s = system
    assert s["n"] == 38
    for name in ("tensor", "jacobian_tensor"):
        assert getattr(s["qgt_p"], name).shape == (39,) * 5
    assert type(s["qgt_p"]).__name__ == type(s["qgt_j"]).__name__


def test_f_and_df_match_jax_and_numpy_backend(system):
    s = system
    x = np.random.default_rng(1).random((2, s["n"])) * 0.02
    xt = torch.as_tensor(x)
    fx = s["f_p"].batched(0., xt).numpy()
    J = s["Df_p"].batched(0., xt).numpy()
    np.testing.assert_allclose(fx, np.asarray(s["f_j"].batched(0., x)),
                               **F_TOL)
    np.testing.assert_allclose(J, np.asarray(s["Df_j"].batched(0., x)),
                               **F_TOL)
    fn, Dfn = make_numpy_tendencies(s["qgt_j"].tensor,
                                    s["qgt_j"].jacobian_tensor)
    for b in range(2):
        np.testing.assert_allclose(fx[b], fn(0., x[b]), **F_TOL)
        np.testing.assert_allclose(J[b], Dfn(0., x[b]), **F_TOL)
    # single states, as the reference calls them
    np.testing.assert_allclose(s["f_p"](0., xt[0]).numpy(), fx[0], rtol=0,
                               atol=0)


def test_from_numpy_on_rank5_arrays(system):
    """``from_numpy`` builds the tendency from the JAX package's rank-5 COO
    arrays."""
    s = system
    t = s["qgt_j"].tensor
    fp = con.from_numpy(np.asarray(t.coords), np.asarray(t.data), t.shape,
                        device="cpu")
    assert fp.shape == (39,) * 5 and fp.two_level
    x = np.random.default_rng(2).random((3, s["n"])) * 0.05
    np.testing.assert_allclose(fp(0., torch.as_tensor(x)).numpy(),
                               np.asarray(s["f_j"].batched(0., x)), **F_TOL)


@pytest.mark.parametrize("variant", ["plain", "adjoint", "inverse"])
def test_direct_tangent_is_jacobian_times_dm(system, variant):
    """``Tangent`` and ``DfTangent`` of the rank-5 Jacobian tensor against
    ``J dm`` (``J^T dm``, ``-J dm``) from the JAX Jacobian: 1e-11."""
    s = system
    kw = {variant: True} if variant != "plain" else {}
    rng = np.random.default_rng(3)
    x = rng.random((3, s["n"])) * 0.05
    xx = torch.as_tensor(np.concatenate([np.ones((3, 1)), x], axis=1))
    dm = torch.as_tensor(rng.standard_normal((3, s["n"], 5)))
    J = np.asarray(s["Df_j"].batched(0., x))
    if variant == "adjoint":
        J = J.transpose(0, 2, 1)
    ref = np.einsum('bnm,bmt->bnt', J, dm.numpy())
    if variant == "inverse":
        ref = -ref
    jt = s["qgt_p"].jacobian_tensor
    tangent = con.make_direct_tangent(jt, device="cpu", **kw)
    assert tangent.coef is not None
    assert np.abs(tangent(xx, dm).numpy() - ref).max() < 1e-11
    got = tf.make_df_tangent_contraction(jt, device="cpu", **kw)(
        tf.df_from_f64(xx), tf.df_from_f64(dm))
    assert np.abs(tf.df_to_f64(got).numpy() - ref).max() < 1e-11


def test_df_tendency_matches_float64(system):
    s = system
    T = s["qgt_p"].tensor
    x = torch.as_tensor(np.random.default_rng(4).random((3, s["n"])) * 0.05)
    got = tf.DfTendency(T.coords, T.data, T.shape, device="cpu")(
        *tf.df_from_f64(x))
    np.testing.assert_allclose(tf.df_to_f64(got).numpy(),
                               s["f_p"].batched(0., x).numpy(), rtol=0,
                               atol=1e-15)


def test_float64_trajectory_matches_jax(system):
    """100 RK4 steps of dt 0.1 through ``RungeKuttaIntegrator`` against
    the JAX float64 integrator."""
    s = system
    _, ref = jax_integrate(s["f_j"].batched, 0., 10., 0.1, s["x0"],
                           write_steps=10)
    integ = RungeKuttaIntegrator()
    integ.set_func(s["f_p"])
    integ.integrate(0., 10., 0.1, ic=s["x0"], write_steps=10)
    t, traj = integ.get_trajectories()
    assert traj.shape == (2, 38, 11) and len(t) == 11
    np.testing.assert_allclose(traj.numpy(), np.asarray(ref), **TRAJ_TOL)


def test_twofloat_trajectory_and_tgls_match_float64(system):
    """Twofloat ``RungeKuttaIntegrator`` (100 steps) and
    ``RungeKuttaTglsIntegrator`` (20 steps, 4 tangent vectors) against
    their float64 runs: 1e-9 and 1e-8."""
    s = system
    runs = {}
    for precision in ("float64", "twofloat"):
        integ = RungeKuttaIntegrator(precision=precision)
        integ.set_func(s["f_p"])
        integ.integrate(0., 10., 0.1, ic=s["x0"], write_steps=0)
        runs[precision] = integ.get_trajectories()[1]
    assert np.abs((runs["twofloat"] - runs["float64"]).numpy()).max() < 1e-9

    tg = np.eye(s["n"])[:, :4].T
    tgls = {}
    for precision in ("float64", "twofloat"):
        integ = RungeKuttaTglsIntegrator(precision=precision)
        integ.set_func(s["f_p"], s["Df_p"])
        integ.integrate(0., 2., 0.1, ic=s["x0"], tg_ic=tg, write_steps=0)
        tgls[precision] = integ.get_trajectories()
    assert tgls["float64"][2].shape == (2, 38, 4)
    assert np.abs((tgls["twofloat"][1] - tgls["float64"][1]).numpy()).max() \
        < 1e-9
    assert np.abs((tgls["twofloat"][2] - tgls["float64"][2]).numpy()).max() \
        < 1e-8


def test_tgls_float64_direct_tangent_matches_jacobian_route(system):
    """The TGLS integrator's Jacobian route against the direct rank-5
    ``Tangent`` route of ``integrate_runge_kutta_tgls``'s step: 1e-11."""
    from qgs_tpu_torch.integrators.rk import make_tgls_step, rk4_tableau
    s = system
    y = torch.as_tensor(s["x0"])
    dm = torch.eye(s["n"], dtype=torch.float64).expand(2, -1, -1)
    tangent = con.make_direct_tangent(s["qgt_p"].jacobian_tensor,
                                      device="cpu")
    steps = [make_tgls_step(s["f_p"].batched, s["Df_p"].batched,
                            *rk4_tableau(), tangent=tg)
             for tg in (None, tangent)]
    (y1, m1), (y2, m2) = (step((y, dm), 0., 0.1) for step in steps)
    assert torch.equal(y1, y2)
    assert float((m1 - m2).abs().max()) < 1e-11


@pytest.mark.parametrize("system", ["t4"], indirect=True)
def test_backward_lyapunovs_match_jax_t4(system):
    """Backward exponents over a few windows on T4 at B = 2 against the
    JAX package's (float64, both through the direct tangent): 1e-9; the
    port's twofloat ones against its float64 ones: 1e-9."""
    s = system
    args = (0., 0.2, 0.5, 0.1, 0.1, s["x0"])
    tj = (s["qgt_j"].tensor, s["qgt_j"].jacobian_tensor)
    tp = (s["qgt_p"].tensor, s["qgt_p"].jacobian_tensor)
    _, _, ej, _ = jl.compute_backward_lyapunovs(
        s["f_j"].batched, s["Df_j"].batched, *args, tensors=tj)
    out = {}
    for precision in ("float64", "twofloat"):
        _, traj, out[precision], vecs = pl.compute_backward_lyapunovs(
            s["f_p"].batched, s["Df_p"].batched, *args, tensors=tp,
            precision=precision, device="cpu")
    assert vecs.shape == (2, 38, 38, 4)
    np.testing.assert_allclose(out["float64"].numpy(), np.asarray(ej),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(out["twofloat"].numpy(),
                               out["float64"].numpy(), rtol=0, atol=1e-9)


def test_two_level_layout_sums_in_order():
    """A hand-made two-level layout (chunk width 2, the fewest slots: no
    width stays within 1.5x): chunks of each row in COO order, pads of
    value and index 0, each row's chunk list padded with the zero column,
    empty outputs placed on the zero column."""
    out_idx = [2, 0, 2, 2, 2, 0]
    lay = con.two_level(out_idx, 4, [[1, 2, 3, 4, 5, 6]],
                        [10., 20., 30., 40., 50., 60.])
    np.testing.assert_array_equal(lay.vals, [[20., 60.], [10., 30.],
                                             [40., 50.]])
    np.testing.assert_array_equal(lay.idxs[0], [[2, 6], [1, 3], [4, 5]])
    np.testing.assert_array_equal(lay.chunks, [[0, 3], [1, 2]])
    np.testing.assert_array_equal(lay.perm, [0, 2, 1, 2])
    counts = np.bincount(out_idx, minlength=4)
    assert [con.two_level_slots(counts, C) for C in (1, 2, 4, 8)] == [
        6 + 8, lay.vals.size + lay.chunks.size, 8 + 2, 16 + 2]
    mod = con._GatherContraction(lay, (4,), torch.float64, "cpu")
    xx = torch.arange(7, dtype=torch.float64)[None] + 1.
    np.testing.assert_array_equal(
        mod.contract(xx).numpy(),
        [[20. * 3 + 60. * 7, 0., 10. * 2 + 30. * 4 + 40. * 5 + 50. * 6, 0.]])


def test_chunk_width_rule():
    """The smallest power of two whose slots stay within the bound, else
    the one with the fewest slots."""
    counts = np.array([64, 60, 50, 40])                   # 214 entries
    assert con.two_level_slots(counts, 2) == 214 + 4 * 32 > 1.5 * 214
    assert con.two_level_slots(counts, 4) == 216 + 4 * 16 <= 1.5 * 214
    assert con.chunk_width(counts) == 4
    counts = np.array([100, 1, 1, 1])       # no width within 1.5 x 103
    slots = {C: con.two_level_slots(counts, C) for C in (4, 8, 16)}
    assert slots == {4: 212, 8: 180, 16: 188}
    assert con.chunk_width(counts) == 8
    assert con.chunk_width(np.array([1, 1, 2])) == 2        # 6 + 3 slots
    assert con.chunk_width(np.zeros(3, np.int64)) == 1


def test_t4_layouts_stay_near_their_entries():
    """On T4, every rank-5 layout (tendency, Jacobian, tangent coefficient
    plain and adjoint) holds at most 1.5 slots a kept entry, both levels
    counted; the tangent forms no (B, nnz, n_tg) or (B, n, R, n_tg)
    intermediate (its buffers are the coefficient's two-level layout)."""
    _, pars = both_params(t4)
    f, Df, qgt = create_tendencies(pars, return_qgtensor=True, device="cpu")
    T, JT = qgt.tensor, qgt.jacobian_tensor
    n = pars.ndim
    kept_t = int((T.coords[0] != 0).sum())
    kept_j = int(((JT.coords[0] != 0) & (JT.coords[1] != 0)).sum())
    mods = {"tendency": (f.batched, kept_t), "jacobian": (Df.batched, kept_j)}
    for adjoint in (False, True):
        mods[f"tangent adjoint={adjoint}"] = (con.make_direct_tangent(
            JT, adjoint=adjoint, device="cpu").coef, kept_j)
    for name, (mod, kept) in mods.items():
        slots = mod.vals.numel() + mod.chunks.numel()
        assert mod.two_level and mod.n_idx == (4 if name == "tendency"
                                               else 3), name
        assert slots <= con.SLOT_BOUND * kept, (name, slots, kept)
    tangent = con.make_direct_tangent(JT, device="cpu")
    assert {k for k, _ in tangent.named_buffers()} == {
        f"coef.{k}" for k in ("vals", "idx0", "idx1", "idx2", "chunks",
                              "perm")}
    assert tangent.coef.out_shape == (n, n)


def test_analytic_blocks_raise():
    """dynamic-T and T4 need symbolic inner products: the reference's
    ``ValueError``, before any tensor is built."""
    for scheme in (dict(dynamic_T=True), dict(T4=True)):
        pars = QgParams(**scheme)
        pars.set_atmospheric_channel_fourier_modes(2, 2)
        pars.set_oceanic_basin_fourier_modes(2, 4)
        pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
        with pytest.raises(ValueError, match="need symbolic inner products: "
                                             "set the atmospheric/oceanic"):
            create_tendencies(pars, device="cpu")


@pytest.mark.parametrize("settings", [maooam, t4], ids=["maooam", "t4"])
def test_probe_never_calls_a_module_with_its_tensor(settings):
    """``infer_ndim`` reads ``shape[0] - 1`` off a module that carries its
    tensor and calls it no time (every probe narrower than the model would
    gather out of bounds); ``initialize`` without ``number_of_dimensions``
    reaches it the same way."""
    _, pars = both_params(settings)
    f, _, qgt = create_tendencies(pars, return_qgtensor=True, device="cpu")
    calls = []
    hook = f.batched.register_forward_pre_hook(lambda m, a: calls.append(1))
    assert infer_ndim(f.batched) == pars.ndim
    T = qgt.tensor
    assert infer_ndim(tf.DfTendency(T.coords, T.data, T.shape,
                                    device="cpu")) == pars.ndim
    assert calls == []
    integ = RungeKuttaIntegrator()
    integ.set_func(f)
    integ.initialize(0.2, 0.1, number_of_trajectories=2,
                     rng=np.random.default_rng(0))
    assert integ.n_dim == pars.ndim and integ.ic.shape == (2, pars.ndim)
    assert len(calls) == 8              # 2 steps of 4 stages, no probe
    hook.remove()
    # a plain callable is still probed
    assert infer_ndim(lambda t, x: f.batched(t, x), device="cpu") == pars.ndim


class _OnCard:
    """A stand-in state of ``dtype`` that reports a CUDA device."""
    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, dtype=torch.float64):
        self.dtype = dtype


def test_rank5_models_route_to_the_step_loop(system, monkeypatch):
    """``fused_route`` on the card (the H100's opt-in limit stands in for
    the card's): classical RK4 of a float64 or float32 rank-5 ``Tendency``
    goes to K5 (its layout fits), and of a double-float one, an RK2
    tableau or a CPU state to the plain step loop; a rank-3 tendency goes
    to K1 and K2 as before (MAOOAM's layout fits), and on the CPU to the
    plain loop."""
    from qgs_tpu_torch.integrators.rk import rk2_tableau, rk4_tableau
    from qgs_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "max_smem_optin", lambda device: 232448)
    s = system
    tab = rk4_tableau()
    T = s["qgt_p"].tensor
    pair = (_OnCard(torch.float32), _OnCard(torch.float32))
    f5 = s["f_p"].batched
    assert fused_route(f5, _OnCard(), tab) is K5
    f5_32 = con.Tendency(T.coords, T.data, T.shape, torch.float32,
                         device="cpu")
    assert fused_route(f5_32, _OnCard(torch.float32), tab) is K5
    assert fused_route(tf.DfTendency(T.coords, T.data, T.shape,
                                     device="cpu"), pair, tab) is None
    assert fused_route(f5, _OnCard(), rk2_tableau()) is None
    assert fused_route(f5, torch.zeros(1, s["n"], dtype=torch.float64),
                       tab) is None
    _, pars3 = both_params(maooam)
    f3, _, q3 = create_tendencies(pars3, return_qgtensor=True, device="cpu")
    assert fused_route(f3.batched, _OnCard(), tab) is K1
    T3 = q3.tensor
    assert fused_route(tf.DfTendency(T3.coords, T3.data, T3.shape,
                                     device="cpu"), pair, tab) is DF
    assert fused_route(f3.batched, torch.zeros(1, 36), tab) is None


def test_rank5_create_tendencies_defaults_to_the_card():
    """With no device, a rank-5 model is built on ``cuda``; where there is
    no card, the call raises and does not land on the CPU."""
    _, pars = both_params(dynamic_t)
    if torch.cuda.is_available():
        f, Df = create_tendencies(pars)
        assert f.batched.device.type == Df.batched.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            create_tendencies(pars)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("settings", [maooam, t4], ids=["maooam", "t4"])
def test_initialize_probe_on_card(card, settings):
    """``initialize(..., rng=)`` without ``number_of_dimensions`` on the
    card, a device sync, then one more integration: no device-side assert
    (an out-of-bounds probe would poison the CUDA context)."""
    _, pars = both_params(settings)
    f, _ = create_tendencies(pars)
    integ = RungeKuttaIntegrator()
    integ.set_func(f)
    integ.initialize(1., 0.1, number_of_trajectories=4,
                     rng=np.random.default_rng(0))
    torch.cuda.synchronize()
    integ.integrate(0., 1., 0.1, write_steps=0)
    _, x = integ.get_trajectories()
    torch.cuda.synchronize()
    assert x.shape == (4, pars.ndim) and bool(torch.isfinite(x).all())


@pytest.mark.cuda
def test_k5_integrate_matches_jax(card, system):
    """``RungeKuttaIntegrator.integrate`` of the rank-5 tensor on the card
    (one K5 launch a card; no K1 launch, no plain contraction) against the
    JAX float64 integrator on the CPU: 64 states, 100 RK4 steps of dt 0.1,
    a record every 10, within 1e-12 of the largest |value| (the port's
    plain loop on the CPU lies 2e-16 from the JAX one there; K5 sums in
    another order)."""
    from qgs_tpu_torch.ops import fused_rk4
    from qgs_tpu_torch.ops import fused_rk4_quartic as k5
    s = system
    T = s["qgt_p"].tensor
    f = con.Tendency(T.coords, T.data, T.shape, torch.float64, device="cuda")
    x0 = np.random.default_rng(11).random((64, s["n"])) * 0.01
    vr = s["pars"].variables_range
    x0[:, vr[0]] = 0.1
    x0[:, vr[2]] = 0.12

    def counts():
        return [k5.launches, fused_rk4.launches, con.two_level_calls]

    before = counts()
    integ = RungeKuttaIntegrator()
    integ.set_func(f)
    integ.integrate(0., 10., 0.1, ic=x0, write_steps=10)
    _, traj = integ.get_trajectories()
    torch.cuda.synchronize()
    assert np.subtract(counts(), before).tolist() == [
        torch.cuda.device_count(), 0, 0]
    _, ref = jax_integrate(s["f_j"].batched, 0., 10., 0.1, x0,
                           write_steps=10)
    ref = np.asarray(ref)
    assert traj.shape == ref.shape == (64, 38, 11)
    assert traj.device.type == "cuda"
    np.testing.assert_allclose(traj.cpu().numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.cuda
def test_forward_lyapunovs_on_card_match_jax(card, system):
    """``compute_forward_lyapunovs`` of the rank-5 model on the card, its
    forward pass one K5 launch (the family ``fused_route`` returns), against
    the JAX package's float64 toolbox on the CPU: the exponents within
    1e-9, as ``test_backward_lyapunovs_match_jax_t4``'s, and the vectors'
    trajectory within 1e-12 of the largest |value|."""
    from qgs_tpu_torch.ops import fused_rk4_quartic as k5
    s = system
    args = (0., 0.2, 0.5, 0.1, 0.1, s["x0"])
    tj = (s["qgt_j"].tensor, s["qgt_j"].jacobian_tensor)
    tp = (s["qgt_p"].tensor, s["qgt_p"].jacobian_tensor)
    _, traj_j, ej, _ = jl.compute_forward_lyapunovs(
        s["f_j"].batched, s["Df_j"].batched, *args, tensors=tj)
    f, Df = con.make_tendency_fns(*tp, device="cuda")
    before = k5.launches
    _, traj, ep, vecs = pl.compute_forward_lyapunovs(f, Df, *args,
                                                     tensors=tp,
                                                     device="cuda")
    torch.cuda.synchronize()
    assert k5.launches - before == 1
    assert vecs.shape == (2, 38, 38, 3) and ep.device.type == "cuda"
    np.testing.assert_allclose(ep.cpu().numpy(), np.asarray(ej), rtol=0,
                               atol=1e-9)
    ref = np.asarray(traj_j)
    np.testing.assert_allclose(traj.cpu().numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
