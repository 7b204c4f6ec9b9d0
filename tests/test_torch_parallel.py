"""The port's parallel layer (``qgs_tpu_torch.parallel``) and the ``mesh=``
arguments of its integrators and Lyapunov toolbox, on the CPU: a mesh that
names the CPU eight times stands for the JAX tests' eight virtual host
devices (``tests/conftest.py``).

* Split ensembles equal the unsplit port bit for bit (each trajectory's
  arithmetic does not depend on the batch), and the JAX package's sharded
  runs at the tolerances of ``tests/test_ensemble.py`` (rtol 1e-12, atol
  1e-13) and of the toolbox tests (1e-9, vectors up to column sign).
* The subspace CLVs' power iteration stops when every member of the batch
  has converged, so a shard may stop sooner than the whole: 1e-12 there.
* The row-sharded tendency equals the unsharded ``Tendency`` bit for bit
  (every row sums the same slots in the same order) and the JAX package's
  at rtol 1e-12, atol 1e-13 (``tests/test_ensemble.py:117-161``).
* The two-process self-test over gloo (``tests/test_distributed.py``).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from qgs_tpu.integrators.integrator import (
    RungeKuttaIntegrator as JaxIntegrator,
)
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu.parallel.mesh import ensemble_mesh as jax_ensemble_mesh
from qgs_tpu.parallel.sharded_tendency import (
    make_sharded_tendency as jax_make_sharded_tendency,
)
from qgs_tpu.toolbox import lyapunov as jl
from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.integrators.integrator import (
    RungeKuttaIntegrator, RungeKuttaTglsIntegrator,
)
from qgs_tpu_torch.integrators.rk import integrate_runge_kutta
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops import fused_df_rk4, fused_rk4
from qgs_tpu_torch.parallel import distributed
from qgs_tpu_torch.parallel.distributed import (
    gather_to_host, host_chip_mesh, make_global_array,
    run_multiprocess_selftest,
)
from qgs_tpu_torch.parallel.mesh import (
    Mesh, ensemble_mesh, ensemble_size, gather_ensemble, pad_batch,
    shard_ensemble,
)
from qgs_tpu_torch.parallel.sharded_tendency import (
    _deal_rows, make_sharded_tendency,
)
from qgs_tpu_torch.toolbox import lyapunov as pl

from tests.test_torch_host import both_params, maooam, rp

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: one intra-op thread (see ``test_torch_lyapunov.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rp_both():
    """The RP system of ``tests/test_ensemble.py:13-19`` in both packages
    (the port's on the CPU)."""
    jax_pars, pars = both_params(rp)
    f_j, Df_j = jax_create_tendencies(jax_pars)
    f_p, Df_p, qgt = create_tendencies(pars, return_qgtensor=True,
                                       device="cpu")
    return dict(f_j=f_j, Df_j=Df_j, f_p=f_p, Df_p=Df_p, n=pars.ndim,
                tensors=(qgt.tensor, qgt.jacobian_tensor))


def _ics(n, B, seed=3):
    return np.random.default_rng(seed).random((B, n)) * 0.05


def _same_up_to_sign(got, ref, atol):
    """Vectors (B, n, n_vec, T) equal up to each column's sign."""
    got, ref = got.numpy(), np.asarray(ref)
    sign = np.sign(np.sum(got * ref, axis=1, keepdims=True))
    np.testing.assert_allclose(got * sign, ref, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_mesh_layout_and_errors():
    """A 1-D mesh of repeated devices; the ensemble size; bad grids, axes
    and mixed device types raise."""
    mesh = ensemble_mesh(CPU8)
    assert mesh.shape == {"ensemble": 8} and ensemble_size(mesh) == 8
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert not mesh.spans_processes()
    assert mesh.local_groups() == [[torch.device("cpu")]] * 8
    with pytest.raises(ValueError, match="axes"):
        Mesh(np.array(CPU8, dtype=object).reshape(4, 2), ("model", "x"))
    with pytest.raises(ValueError, match="2-D"):
        Mesh(CPU8, ("ensemble", "model"))
    with pytest.raises(ValueError, match="one type"):
        Mesh(["cpu", "meta"])


def test_shard_pad_and_gather_round_trip():
    """13 rows on 8 entries: padded with the last row to 16, shards of 2,
    and the inverse cuts back to 13; a NumPy array is accepted."""
    x = np.arange(13 * 3, dtype=np.float64).reshape(13, 3)
    padded, n = pad_batch(torch.as_tensor(x), 8)
    assert n == 13 and padded.shape == (16, 3)
    assert torch.equal(padded[13:], torch.as_tensor(x[[12, 12, 12]]))
    mesh = ensemble_mesh(CPU8)
    shards, n = shard_ensemble(x, mesh)
    assert n == 13 and [tuple(s.shape) for s in shards] == [(2, 3)] * 8
    assert all(s.is_contiguous() for s in shards)
    assert np.array_equal(gather_ensemble(shards, mesh, n).numpy(), x)
    # along another axis, part by part
    pairs = [(s.T, -s.T) for s in shards]
    back = gather_ensemble(pairs, mesh, n, dim=1)
    assert np.array_equal(back[0].numpy(), x.T)
    assert np.array_equal(back[1].numpy(), -x.T)


def test_default_mesh_is_every_card_or_raises():
    """``ensemble_mesh()`` is every visible card; without one it raises.
    A CPU integrator's default mesh is its one device, with no CUDA call."""
    if torch.cuda.is_available():
        assert ensemble_size(ensemble_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ensemble_mesh()
    integ = RungeKuttaIntegrator(device="cpu")
    assert integ.mesh.shape == {"ensemble": 1}
    assert integ.mesh.devices[0] == torch.device("cpu")


def test_replica_is_made_once_per_device():
    """A module is copied once per device and function; on its own device,
    and for a plain callable, the function itself is used."""
    f, _ = create_tendencies(rp(QgParams), device="cpu")
    mesh = ensemble_mesh(CPU8)
    assert mesh.replica(f.batched, torch.device("cpu")) is f.batched

    def g(t, x):
        return x

    assert mesh.replica(g, torch.device("meta")) is g
    r1 = mesh.replica(f.batched, torch.device("meta"))
    assert r1 is not f.batched and r1.device.type == "meta"
    assert mesh.replica(f.batched, torch.device("meta")) is r1
    assert f.batched.device.type == "cpu"


# ---------------------------------------------------------------------------
# sharded ensembles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [16, 13])
def test_sharded_integration_matches_unsharded_and_jax(rp_both, B):
    """The port's ``integrate`` on 8 CPU entries: bit for bit the unsharded
    port, and JAX's ``RungeKuttaIntegrator()`` on its 8 virtual devices at
    rtol 1e-12, atol 1e-13 (``tests/test_ensemble.py:42``)."""
    s = rp_both
    ics = _ics(s["n"], B, 0)
    sharded = RungeKuttaIntegrator(mesh=ensemble_mesh(CPU8))
    sharded.set_func(s["f_p"])
    sharded.integrate(0., 20., 0.1, ic=ics, write_steps=10)
    t, y = sharded.get_trajectories()
    assert tuple(y.shape) == (B, s["n"], len(t))

    single = RungeKuttaIntegrator(device="cpu")
    single.set_func(s["f_p"])
    single.integrate(0., 20., 0.1, ic=ics, write_steps=10)
    t1, y1 = single.get_trajectories()
    assert np.array_equal(t, t1) and torch.equal(y, y1)

    ref = JaxIntegrator()
    assert len(ref.mesh.devices.ravel()) == 8
    ref.set_func(s["f_j"])
    ref.integrate(0., 20., 0.1, ic=ics, write_steps=10)
    tj, yj = ref.get_trajectories()
    assert np.array_equal(t, np.asarray(tj))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-12,
                               atol=1e-13)


@pytest.mark.parametrize("B", [16, 13, 5])
def test_each_shard_runs_its_own_batch(rp_both, B):
    """A plain callable sees only shards of ceil(B / 8) members when the
    batch fills the mesh (13 padded to 16), and the whole batch when it does
    not (5 < 8)."""
    s = rp_both
    sizes = set()

    def g(t, x):
        sizes.add(x.shape[0])
        return s["f_p"].batched(t, x)

    integrate_runge_kutta(g, 0., 0.3, 0.1, _ics(s["n"], B), device="cpu",
                          mesh=ensemble_mesh(CPU8))
    assert sizes == ({2} if B >= 8 else {B})


def test_twofloat_sharded_equals_unsharded(rp_both):
    """``precision='twofloat'`` on 8 CPU entries, B = 13: bit for bit the
    unsharded twofloat run."""
    s = rp_both
    ics = _ics(s["n"], 13)
    out = []
    for mesh in (ensemble_mesh(CPU8), None):
        integ = RungeKuttaIntegrator(precision="twofloat", mesh=mesh,
                                     device="cpu")
        integ.set_func(s["f_p"])
        integ.integrate(0., 2., 0.1, ic=ics, write_steps=3)
        out.append(integ.get_trajectories())
    assert np.array_equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


# ---------------------------------------------------------------------------
# the counterparts of tests/test_sharded_toolbox.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["float64", "twofloat"])
def test_tgls_integrator_sharded_matches_single_device(rp_both, precision):
    """Full fundamental matrices (B, n, n) split with their states over 8
    entries, B = 16: bit for bit the unsharded run."""
    s = rp_both
    ics = _ics(s["n"], 16)
    out = []
    for mesh in (ensemble_mesh(CPU8), None):
        tint = RungeKuttaTglsIntegrator(mesh=mesh, device="cpu",
                                        precision=precision)
        tint.set_func(s["f_p"], s["Df_p"])
        tint.integrate(0., 1., 0.1, ic=ics, tg_ic=np.eye(s["n"]),
                       write_steps=5)
        out.append(tint.get_trajectories())
    assert np.array_equal(out[0][0], out[1][0])
    assert tuple(out[0][2].shape) == (16, s["n"], s["n"], 3)
    for a, b in zip(out[0][1:], out[1][1:]):
        assert torch.equal(a, b)


def test_tgls_integrator_sharded_adjoint_identity(rp_both):
    """``<TL x, y> == <x, AD y>`` on the sharded path (one step, atol 1e-3,
    ``tests/test_sharded_toolbox.py:61-86``), and the sharded adjoint equal
    to the unsharded one bit for bit."""
    s = rp_both
    ics = _ics(s["n"], 8)
    rng = np.random.default_rng(5)
    x, y = rng.standard_normal(s["n"]), rng.standard_normal(s["n"])
    tint = RungeKuttaTglsIntegrator(mesh=ensemble_mesh(CPU8))
    tint.set_func(s["f_p"], s["Df_p"])
    tint.integrate(0., 0.1, 0.1, ic=ics, tg_ic=x, write_steps=0)
    tl_x = tint.get_trajectories()[2].numpy()
    tint.integrate(0., 0.1, 0.1, ic=ics, tg_ic=y, write_steps=0, adjoint=True)
    ad_y = tint.get_trajectories()[2]
    np.testing.assert_allclose(tl_x @ y, ad_y.numpy() @ x, rtol=0, atol=1e-3)

    single = RungeKuttaTglsIntegrator(device="cpu")
    single.set_func(s["f_p"], s["Df_p"])
    single.integrate(0., 0.1, 0.1, ic=ics, tg_ic=y, write_steps=0,
                     adjoint=True)
    assert torch.equal(ad_y, single.get_trajectories()[2])


TOOLBOX_CASES = {
    "backward": ("compute_backward_lyapunovs", (0., 2., 6.), 8),
    "backward-unpadded": ("compute_backward_lyapunovs", (0., 2., 6.), 11),
    "ginelli": ("compute_clvs_ginelli", (0., 2., 4., 6.), 8),
}


@pytest.mark.parametrize("case", list(TOOLBOX_CASES))
def test_toolbox_sharded_matches_jax_and_unsharded(rp_both, case):
    """BLV (B = 8, and 11, which 8 does not divide) and Ginelli CLVs with
    ``mesh=`` on 8 entries: against the JAX package's on its 8 virtual
    devices, exponents atol 1e-9 and vectors up to column sign atol 1e-9;
    against the port unsharded, rtol 1e-12, atol 1e-12 (``B`` members come
    back)."""
    s = rp_both
    name, span, B = TOOLBOX_CASES[case]
    ics = _ics(s["n"], B)
    args = span + (0.1, 0.1, ics)
    out = getattr(pl, name)(s["f_p"].batched, s["Df_p"].batched, *args,
                            write_steps=2, mesh=ensemble_mesh(CPU8))
    single = getattr(pl, name)(s["f_p"].batched, s["Df_p"].batched, *args,
                               write_steps=2, device="cpu")
    ref = getattr(jl, name)(s["f_j"].batched, s["Df_j"].batched, *args,
                            write_steps=2, mesh=jax_ensemble_mesh())
    assert out[1].shape[0] == B
    assert np.array_equal(out[0], single[0])
    assert np.array_equal(out[0], np.asarray(ref[0]))
    for got, one in zip(out[1:], single[1:]):
        np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-12,
                                   atol=1e-12)
    for got, r in zip(out[1:3], ref[1:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-9)
    _same_up_to_sign(out[3], ref[3], 1e-9)


def test_forward_and_subspace_sharded_match_unsharded(rp_both):
    """FLVs, the subspace CLVs (with their BLVs and FLVs) and twofloat
    BLVs with ``mesh=`` on 8 entries, B = 9: against the port unsharded,
    rtol 1e-12, atol 1e-12."""
    s = rp_both
    ics = _ics(s["n"], 9)
    mesh = ensemble_mesh(CPU8)
    runs = [
        ("compute_forward_lyapunovs", (0., 2., 4.), {}),
        ("compute_clvs_subspace", (0., 1., 2., 3.),
         dict(return_blvs=True, return_flvs=True)),
        ("compute_backward_lyapunovs", (0., 1., 2.),
         dict(precision="twofloat", tensors=s["tensors"])),
    ]
    for name, span, kw in runs:
        args = (s["f_p"].batched, s["Df_p"].batched) + span + (0.1, 0.1, ics)
        got = getattr(pl, name)(*args, write_steps=2, mesh=mesh, **kw)
        ref = getattr(pl, name)(*args, write_steps=2, device="cpu", **kw)
        assert np.array_equal(got[0], ref[0])
        flat = (lambda o: [p for x in o[1:]
                           for p in (x if isinstance(x, tuple) else (x,))])
        for a, b in zip(flat(got), flat(ref)):
            assert a.shape == b.shape and a.shape[0] == 9
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12)


def test_ginelli_noise_follows_the_member(rp_both):
    """With ``noise_pert > 0`` each member draws the noise it draws
    unsharded, so the split Ginelli run equals the unsplit one (B = 13,
    padded to 16)."""
    s = rp_both
    ics = _ics(s["n"], 13)
    args = (s["f_p"].batched, s["Df_p"].batched, 0., 1., 2., 3., 0.1, 0.1,
            ics)
    got = pl.compute_clvs_ginelli(*args, noise_pert=0.01,
                                  mesh=ensemble_mesh(CPU8))
    ref = pl.compute_clvs_ginelli(*args, noise_pert=0.01, device="cpu")
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_estimators_accept_mesh(rp_both):
    """Both estimators take ``mesh=`` and return every member."""
    s = rp_both
    ics = _ics(s["n"], 8)
    mesh = ensemble_mesh(CPU8)
    est = pl.LyapunovsEstimator(mesh=mesh)
    est.set_func(s["f_p"], s["Df_p"])
    est.compute_lyapunovs(0., 2., 8., 0.1, 0.1, ics, write_steps=2)
    t, traj, exps, vecs = est.get_lyapunovs()
    assert traj.shape[0] == 8 and np.isfinite(exps).all()

    cest = pl.CovariantLyapunovsEstimator(mesh=mesh)
    cest.set_func(s["f_p"], s["Df_p"])
    cest.compute_clvs(0., 2., 4., 6., 0.1, 0.1, ics, write_steps=2)
    t, traj, exps, vecs = cest.get_clvs()
    assert traj.shape[0] == 8 and np.isfinite(vecs).all()


# ---------------------------------------------------------------------------
# the model axis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def maooam_both():
    jax_pars, pars = both_params(maooam)
    _, _, qgt_j = jax_create_tendencies(jax_pars, return_qgtensor=True)
    f, _, qgt = create_tendencies(pars, return_qgtensor=True, device="cpu")
    x = np.random.default_rng(11).random((16, pars.ndim)) * 0.05
    return dict(tensor_j=qgt_j.tensor, tensor=qgt.tensor, f=f, x=x)


@pytest.mark.parametrize("kernel", ["auto", "dense"])
def test_row_sharded_tendency_on_a_4x2_grid(maooam_both, kernel):
    """``make_sharded_tendency`` on a 4 x 2 (ensemble x model) CPU grid, B =
    16 (and 13, padded): bit for bit the unsharded ``Tendency``, and the JAX
    package's on its 4 x 2 virtual mesh at rtol 1e-12, atol 1e-13."""
    s = maooam_both
    grid = host_chip_mesh(2, CPU8)
    f_sh = make_sharded_tendency(s["tensor"], grid, kernel=kernel)
    x = torch.as_tensor(s["x"])
    out = f_sh(0., x)
    assert out.dtype == torch.float64
    assert torch.equal(out, s["f"].batched(0., x))
    assert torch.equal(f_sh(0., x[:13]), s["f"].batched(0., x[:13]))

    jmesh = JaxMesh(np.array(jax.devices()).reshape(4, 2),
                    ("ensemble", "model"))
    xs = jax.device_put(s["x"], NamedSharding(jmesh, P("ensemble", None)))
    ref = jax.jit(jax_make_sharded_tendency(
        s["tensor_j"], jmesh, kernel="bucketed" if kernel == "auto"
        else kernel))(0., xs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-13)


def test_row_sharded_tendency_deals_whole_rows(maooam_both):
    """Each model entry holds whole rows, about as many as the others;
    ``kernel='dense'`` with ``overlap_chunks`` (which has no effect) gives
    the same result."""
    s = maooam_both
    grid = host_chip_mesh(2, CPU8)
    x = torch.as_tensor(s["x"])
    one = make_sharded_tendency(s["tensor"], grid)(0., x)
    two = make_sharded_tendency(s["tensor"], grid, kernel="dense",
                                overlap_chunks=2)(0., x)
    assert torch.equal(one, two)
    rows = np.asarray(s["tensor"].coords[0])
    counts = np.bincount(rows[rows != 0] - 1, minlength=36)
    owner, pos, W = _deal_rows(counts, 2)
    assert W == 18 and np.bincount(owner[owner >= 0]).tolist() == [18, 18]
    for m in range(2):
        assert sorted(pos[owner == m]) == list(range(18))


def test_row_sharded_tendency_errors(maooam_both):
    """The JAX package's errors: ``overlap_chunks`` with the row kernel, an
    unknown kernel, chunks that do not divide the per-device batch (4 here,
    at the call); and a mesh without a model axis."""
    s = maooam_both
    grid = host_chip_mesh(2, CPU8)
    with pytest.raises(ValueError, match="overlap_chunks applies"):
        make_sharded_tendency(s["tensor"], grid, overlap_chunks=2)
    with pytest.raises(ValueError, match="unknown sharded kernel"):
        make_sharded_tendency(s["tensor"], grid, kernel="psum")
    f3 = make_sharded_tendency(s["tensor"], grid, kernel="dense",
                               overlap_chunks=3)
    with pytest.raises(ValueError, match="must divide the per-device"):
        f3(0., torch.as_tensor(s["x"]))
    with pytest.raises(ValueError, match="no 'model' axis"):
        make_sharded_tendency(s["tensor"], ensemble_mesh(CPU8))


# ---------------------------------------------------------------------------
# multiple processes
# ---------------------------------------------------------------------------

def test_host_chip_mesh_layout():
    """8 devices in one process: model groups of 2 consecutive devices;
    3 does not divide 8 (``tests/test_distributed.py:27-32``)."""
    mesh = host_chip_mesh(model_axis_size=2, devices=CPU8)
    assert mesh.shape == {"ensemble": 4, "model": 2}
    assert len(mesh.local_groups()) == 4
    assert all(len(g) == 2 for g in mesh.local_groups())
    with pytest.raises(ValueError, match="must divide"):
        host_chip_mesh(model_axis_size=3, devices=CPU8)


def test_gather_to_host_single_process():
    """Shards of a host array, gathered back in one process."""
    mesh = host_chip_mesh(model_axis_size=1, devices=CPU8)
    x = np.arange(32, dtype=np.float64).reshape(8, 4)
    g = make_global_array(x, mesh)
    assert len(g) == 8
    np.testing.assert_array_equal(gather_to_host(g), x)
    with pytest.raises(ValueError, match="does not divide"):
        make_global_array(x[:7], mesh)


def test_initialize_is_a_no_op_outside_a_job(monkeypatch):
    """Without torchrun's environment or an address, ``initialize`` joins
    nothing, and the self-test module refuses to run without arguments."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert not distributed.is_distributed()
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed._main([])


def test_gather_through_a_one_rank_group():
    """In a one-rank gloo group ``gather_to_host`` and ``all_gather_blocks``
    run the all-gather (along the batch axis and another) and return the
    block unchanged; ``initialize`` is idempotent."""
    distributed.initialize(f"localhost:{distributed.free_port()}", 1, 0,
                           backend="gloo")
    try:
        distributed.initialize(f"localhost:{distributed.free_port()}", 1, 0)
        assert torch.distributed.get_world_size() == 1
        assert not distributed.is_distributed()
        x = torch.arange(24, dtype=torch.float64).reshape(6, 4)
        np.testing.assert_array_equal(distributed.gather_to_host(x, 5),
                                      x[:5].numpy())
        assert torch.equal(distributed.all_gather_blocks(x.T, dim=1), x.T)
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()


def test_multiprocess_ensemble_and_model_axes():
    """Two processes of two CPU entries each over gloo: the ensemble axis
    spans the processes and the model axis stays in each; every check of
    the self-test holds against one device in both."""
    reports = run_multiprocess_selftest(num_processes=2, local_devices=2,
                                        model_axis_size=2)
    assert len(reports) == 2
    for r in reports:
        assert "mesh={'ensemble': 2, 'model': 2}" in r
        assert "model-rowshard" in r


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels have no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,kernel", [("float64", fused_rk4),
                                              ("twofloat", fused_df_rk4)],
                         ids=["K1", "K2"])
def test_two_entry_card_mesh_is_bit_equal(cuda_device, precision, kernel):
    """MAOOAM on a mesh naming ``cuda:0`` twice, B = 1001: one launch a
    shard (2), and bit for bit the unsharded run (1 launch)."""
    f, _ = create_tendencies(maooam(QgParams), device=cuda_device)
    ics = np.random.default_rng(0).random((1001, 36)) * 0.01
    out = []
    for mesh, count in ((ensemble_mesh([cuda_device] * 2), 2),
                        (ensemble_mesh([cuda_device]), 1)):
        integ = RungeKuttaIntegrator(mesh=mesh, precision=precision)
        integ.set_func(f)
        before = kernel.launches
        integ.integrate(0., 30., 0.1, ic=ics, write_steps=7)
        torch.cuda.synchronize()
        assert kernel.launches == before + count
        out.append(integ.get_trajectories()[1])
    assert torch.equal(out[0], out[1])
