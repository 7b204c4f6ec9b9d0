"""The JAX package's parameters that the port accepts, each held against
the JAX package on the same seeded NumPy input, on the CPU
(``tests/test_torch_parity_inventory.py`` lists those it does not carry):

* ``dtype=`` of ``rk4_tableau``, ``rk2_tableau``, ``make_rk_step`` and
  ``make_tgls_step`` (a torch dtype, default float64; as in the JAX
  package the tableau stays float64 and a step runs in its state's dtype):
  rtol 1e-12, atol 1e-14;
* ``arr`` of ``gather_to_host`` and ``local_device_ids`` of
  ``initialize``;
* the COO tensors as the first arguments of ``integrate_runge_kutta_df``
  and ``integrate_runge_kutta_tgls_df``: bit-equal to the call on the
  ``DfTendency`` / ``DfTangent`` modules, and against the JAX float64
  integrators at the tolerance of ``tests/test_torch_twofloat.py`` (rtol
  1e-9, atol 1e-11; matrices atol 1e-11 max|M|).  The JAX package's own
  double-float tier runs on XLA:CPU with its error-free-transformation
  barriers stripped, about 5e-10 from float64 here, so the port's
  double-float results are held against its float64 ones, as that file
  holds them.  On the card the COO call launches K2 once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgs_tpu.integrators import rk as jax_rk
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu.parallel import distributed as jax_distributed
from qgs_tpu_torch.integrators import rk
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops import fused_df_rk4
from qgs_tpu_torch.ops import twofloat as tf
from qgs_tpu_torch.parallel import distributed, mesh

from tests.test_torch_host import both_params, maooam

TOL64 = dict(rtol=1e-12, atol=1e-14)
TOL = dict(rtol=1e-9, atol=1e-11)
DTYPES = {"float64": (torch.float64, jnp.float64),
          "float32": (torch.float32, jnp.float32)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread (the suite's workers would
    oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system():
    """MAOOAM (ndim 36) in both packages, the port's on the CPU, and three
    seeded states."""
    jax_pars, pars = both_params(maooam)
    f_j, Df_j = jax_create_tendencies(jax_pars)
    f_p, Df_p, qgt = create_tendencies(pars, return_qgtensor=True,
                                       device="cpu")
    ic = np.random.default_rng(11).random((3, pars.ndim)) * 0.05
    return dict(f_j=f_j, Df_j=Df_j, f_p=f_p, Df_p=Df_p, qgt=qgt, ic=ic,
                n=pars.ndim)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["rk4_tableau", "rk2_tableau"])
def test_tableau_dtype_matches_jax(name, dtype):
    port_dtype, jax_dtype = DTYPES[dtype]
    got = getattr(rk, name)(dtype=port_dtype)
    ref = getattr(jax_rk, name)(dtype=jax_dtype)
    for g, r in zip(got, ref):
        assert g.dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_make_rk_step_dtype_matches_jax(system, dtype):
    """Ten RK4 steps of a float64 state with ``dtype=`` given."""
    port_dtype, jax_dtype = DTYPES[dtype]
    step_p = rk.make_rk_step(system["f_p"].batched,
                             *rk.rk4_tableau(dtype=port_dtype),
                             dtype=port_dtype)
    step_j = jax_rk.make_rk_step(system["f_j"].batched,
                                 *jax_rk.rk4_tableau(dtype=jax_dtype),
                                 dtype=jax_dtype)
    yp, yj = torch.as_tensor(system["ic"]), jnp.asarray(system["ic"])
    for s in range(10):
        yp, yj = step_p(yp, 0.1 * s, 0.1), step_j(yj, 0.1 * s, 0.1)
    assert yp.dtype == torch.float64
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL64)


@pytest.mark.parametrize("adjoint", [False, True])
def test_make_tgls_step_dtype_matches_jax(system, adjoint):
    """Five coupled steps with the Jacobian materialized, ``dtype=``
    given."""
    n = system["n"]
    tab_p, tab_j = rk.rk4_tableau(), jax_rk.rk4_tableau()
    step_p = rk.make_tgls_step(system["f_p"].batched, system["Df_p"].batched,
                               *tab_p, adjoint=adjoint, dtype=torch.float64)
    step_j = jax_rk.make_tgls_step(system["f_j"].batched,
                                   system["Df_j"].batched, *tab_j,
                                   adjoint=adjoint, dtype=jnp.float64)
    dm = np.broadcast_to(np.eye(n)[None], (3, n, n))
    cp = (torch.as_tensor(system["ic"]), torch.as_tensor(dm.copy()))
    cj = (jnp.asarray(system["ic"]), jnp.asarray(dm))
    for s in range(5):
        cp, cj = step_p(cp, 0.1 * s, 0.1), step_j(cj, 0.1 * s, 0.1)
    for got, ref in zip(cp, cj):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL64)


def test_gather_to_host_takes_arr(system):
    """``gather_to_host(arr=...)`` outside a process group: the whole
    array, as the JAX package's returns it for an addressable array."""
    x = system["ic"]
    got = distributed.gather_to_host(arr=torch.as_tensor(x))
    ref = jax_distributed.gather_to_host(arr=jnp.asarray(x))
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, np.asarray(ref))
    shards = [torch.as_tensor(x[:1]), torch.as_tensor(x[1:])]
    np.testing.assert_array_equal(distributed.gather_to_host(arr=shards), x)


def test_initialize_takes_local_device_ids(monkeypatch):
    """Outside a job ``initialize(local_device_ids=...)`` joins nothing in
    either package; in a one-rank gloo group the ids become the process's
    devices, and ``shutdown`` forgets them."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
              "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(k, raising=False)
    assert jax_distributed.initialize(local_device_ids=[1]) is None
    assert distributed.initialize(local_device_ids=[1]) is None
    assert not jax_distributed.is_distributed()
    assert not torch.distributed.is_initialized()
    assert mesh.LOCAL_DEVICE_IDS is None

    distributed.initialize(f"localhost:{distributed.free_port()}", 1, 0,
                           local_device_ids=[1, 2], backend="gloo")
    try:
        assert mesh.LOCAL_DEVICE_IDS == [1, 2]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert mesh.local_devices() == [torch.device("cuda", 1),
                                        torch.device("cuda", 2)]
    finally:
        distributed.shutdown()
    assert mesh.LOCAL_DEVICE_IDS is None
    assert not torch.distributed.is_initialized()


def _df_modules(qgt, device):
    T, JT = qgt.tensor, qgt.jacobian_tensor
    return (tf.DfTendency(T.coords, T.data, T.shape, device=device),
            tf.DfTangent(JT.coords, JT.data, JT.shape, device=device))


@pytest.mark.parametrize("forward", [True, False])
def test_integrate_df_takes_the_coo_tensor(system, forward):
    """``integrate_runge_kutta_df(qgtensor.tensor, ...)``, the JAX
    package's call, bit-equal to the call on a ``DfTendency`` and within
    the trajectory tolerance of the JAX float64 integrator."""
    kw = dict(write_steps=5, forward=forward)
    T = system["qgt"].tensor
    t_p, y_p = rk.integrate_runge_kutta_df(T, 0., 5.05, 0.1, system["ic"],
                                           device="cpu", **kw)
    _, y_m = rk.integrate_runge_kutta_df(_df_modules(system["qgt"], "cpu")[0],
                                         0., 5.05, 0.1, system["ic"], **kw)
    assert torch.equal(y_p, y_m)
    t_j, y_j = jax_rk.integrate_runge_kutta(system["f_j"].batched, 0., 5.05,
                                            0.1, system["ic"], **kw)
    assert np.array_equal(t_p, t_j)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), **TOL)


def test_integrate_tgls_df_takes_the_coo_tensors(system):
    """``integrate_runge_kutta_tgls_df(tensor, jtensor, ...)`` with the
    COO tensors, bit-equal to the call on the modules and against the JAX
    float64 TGLS integrator (the adjoint, a record every 7 steps)."""
    n = system["n"]
    qgt = system["qgt"]
    args = (0., 3.05, 0.1, system["ic"], np.eye(n))
    kw = dict(write_steps=7, adjoint=True)
    t_p, y_p, m_p = rk.integrate_runge_kutta_tgls_df(
        qgt.tensor, qgt.jacobian_tensor, *args, device="cpu", **kw)
    _, y_m, m_m = rk.integrate_runge_kutta_tgls_df(
        *_df_modules(qgt, "cpu"), *args, **kw)
    assert torch.equal(y_p, y_m) and torch.equal(m_p, m_m)
    t_j, y_j, m_j = jax_rk.integrate_runge_kutta_tgls(
        system["f_j"].batched, system["Df_j"].batched, *args, **kw)
    assert np.array_equal(t_p, t_j)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), **TOL)
    m_j = np.asarray(m_j)
    np.testing.assert_allclose(m_p.numpy(), m_j, rtol=TOL["rtol"],
                               atol=TOL["atol"] * max(np.abs(m_j).max(), 1))


@pytest.mark.cuda
def test_integrate_df_coo_launches_k2_once_on_the_card(system):
    """On the card the COO call is one K2 launch, bit-equal to the call on
    a ``DfTendency`` (itself one launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused double-float RK4 kernel "
                    "has no CPU build")
    dev = torch.device("cuda", 0)
    ic = torch.as_tensor(np.random.default_rng(3).random((64, system["n"]))
                         * 0.05, device=dev)
    before = fused_df_rk4.launches
    _, y_p = rk.integrate_runge_kutta_df(system["qgt"].tensor, 0., 30.05,
                                         0.1, ic, write_steps=7)
    torch.cuda.synchronize()
    assert fused_df_rk4.launches == before + 1
    _, y_m = rk.integrate_runge_kutta_df(_df_modules(system["qgt"], dev)[0],
                                         0., 30.05, 0.1, ic, write_steps=7)
    torch.cuda.synchronize()
    assert fused_df_rk4.launches == before + 2
    assert torch.equal(y_p, y_m)
