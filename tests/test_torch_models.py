"""The port's model-level modules against the JAX package's on the CPU:
``create_atmo_thermo_tendencies`` (rank 3 on MAOOAM, rank 5 on dynamic-T;
1e-12), ``QgsModel`` with its save and load and the trajectory checkpoints
(``tests/test_model_and_ground.py:48-70``), and
``TrajectoriesStatistics.compute_stats`` on the same initial conditions
(1e-10)."""

import numpy as np
import pytest
import torch

from qgs_tpu.integrators.integrator import (
    RungeKuttaIntegrator as JaxRungeKuttaIntegrator,
)
from qgs_tpu.integrators.statistics import (
    TrajectoriesStatistics as JaxTrajectoriesStatistics,
)
from qgs_tpu.models.model import QgsModel as JaxQgsModel
from qgs_tpu.models.tendencies import (
    create_atmo_thermo_tendencies as jax_create_atmo_thermo_tendencies,
)
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.integrators.statistics import TrajectoriesStatistics
from qgs_tpu_torch.models.model import (QgsModel, load_trajectory_checkpoint,
                                        save_trajectory_checkpoint)
from qgs_tpu_torch.models.tendencies import create_atmo_thermo_tendencies

from tests.test_torch_host import both_params, dynamic_t, maooam, rp

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread (see ``test_torch_tgls.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rp_models():
    """The qgs_rp configuration as a ``QgsModel`` of each package (the
    port's on the CPU)."""
    jax_pars, pars = both_params(rp)
    return JaxQgsModel(jax_pars), QgsModel(pars, device="cpu")


@pytest.mark.parametrize("settings, rank", [(maooam, 3), (dynamic_t, 5)],
                         ids=["maooam", "dynT"])
def test_atmo_thermo_tendencies_match_jax(settings, rank):
    jax_pars, pars = both_params(settings)
    fj, tj = jax_create_atmo_thermo_tendencies(
        jax_pars, return_atmo_thermo_tensor=True)
    fp, tp = create_atmo_thermo_tendencies(
        pars, return_atmo_thermo_tensor=True, device="cpu")
    assert len(tp.tensor.shape) == rank
    assert type(tp).__name__ == type(tj).__name__
    x = np.random.default_rng(0).random((3, pars.ndim)) * 0.05
    got = fp.batched(0., torch.as_tensor(x))
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(fj.batched(0., x)),
                               **TOL)
    np.testing.assert_allclose(fp(0., torch.as_tensor(x[0])).numpy(),
                               np.asarray(fj(0., x[0])), **TOL)
    f_only = create_atmo_thermo_tendencies(pars, device="cpu")
    np.testing.assert_array_equal(f_only.batched(0., torch.as_tensor(x)),
                                  got)


def test_atmo_thermo_tendencies_default_to_the_card():
    _, pars = both_params(maooam)
    if torch.cuda.is_available():
        assert create_atmo_thermo_tendencies(pars).batched.device.type \
            == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            create_atmo_thermo_tendencies(pars)


def test_qgs_model_save_load(tmp_path, rp_models):
    """``QgsModel`` against the JAX package's, its save and load (the
    restored model equal bit for bit), and the trajectory checkpoints of
    NumPy arrays and of tensors."""
    jax_model, model = rp_models
    x = np.random.default_rng(0).random(model.ndim) * 0.05
    fx = model.f(0., torch.as_tensor(x))
    assert model.ndim == 20 and model.f.batched is model.f_batched
    assert model.f.qgtensor is model.tensor
    np.testing.assert_allclose(fx.numpy(), np.asarray(jax_model.f(0., x)),
                               **TOL)
    np.testing.assert_allclose(model.Df(0., torch.as_tensor(x)).numpy(),
                               np.asarray(jax_model.Df(0., x)), **TOL)

    path = tmp_path / "model.qgs"
    model.save(path)
    restored = QgsModel.load(path, device="cpu")
    assert restored.ndim == model.ndim and restored.inner_products is None
    assert type(restored.params).__module__.startswith("qgs_tpu_torch.")
    assert torch.equal(restored.f(0., torch.as_tensor(x)), fx)

    ck = tmp_path / "traj.npz"
    save_trajectory_checkpoint(ck, 123.4, x, note=np.array([1, 2, 3]))
    t, state, extra = load_trajectory_checkpoint(ck)
    assert float(t) == 123.4
    assert np.allclose(state, x)
    assert np.allclose(extra["note"], [1, 2, 3])
    save_trajectory_checkpoint(ck, torch.tensor(1.5), fx, m=fx[:3])
    t, state, extra = load_trajectory_checkpoint(ck)
    assert float(t) == 1.5
    np.testing.assert_array_equal(state, fx.numpy())
    np.testing.assert_array_equal(extra["m"], fx[:3].numpy())


def test_qgs_model_runs_the_integrator(rp_models):
    """The model's ``f`` drives ``RungeKuttaIntegrator`` (float64 and
    twofloat), as the JAX package's does: 1e-9."""
    jax_model, model = rp_models
    ic = np.random.default_rng(1).random((2, model.ndim)) * 0.01
    ref = JaxRungeKuttaIntegrator()
    ref.set_func(jax_model.f)
    ref.integrate(0., 10., 0.1, ic=ic, write_steps=0)
    for precision in ("float64", "twofloat"):
        integ = RungeKuttaIntegrator(precision=precision)
        integ.set_func(model.f)
        integ.integrate(0., 10., 0.1, ic=ic, write_steps=0)
        np.testing.assert_allclose(integ.get_trajectories()[1].numpy(),
                                   np.asarray(ref.get_trajectories()[1]),
                                   rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("num", [1, 3])
def test_statistics_match_jax(rp_models, num):
    """``compute_stats`` of two observables (the final state, the mean
    square over the records) over 6 trajectories in ``num`` batches,
    against the JAX package's: 1e-10; the means are tensors on the
    integration's device."""
    jax_model, model = rp_models
    ic = np.random.default_rng(2).random((6, model.ndim)) * 0.01
    stats = {}
    for pkg, Integrator, Stats, f, arr in (
            ("jax", JaxRungeKuttaIntegrator, JaxTrajectoriesStatistics,
             jax_model.f, np.asarray),
            ("port", RungeKuttaIntegrator, TrajectoriesStatistics, model.f,
             lambda a: a)):
        integ = Integrator()
        integ.set_func(f)
        st = Stats()
        st.set_integrator(integ)
        st.set_func_list([lambda tr, arr=arr: arr(tr)[:, :, -1],
                          lambda tr, arr=arr: (arr(tr) ** 2).mean(-1)])
        stats[pkg] = st.compute_stats(0., 5., 0.1, ic=ic, write_steps=5,
                                      num=num)
    got = stats["port"]
    assert torch.is_tensor(got) and got.shape == (2, model.ndim)
    np.testing.assert_allclose(got.numpy(), np.asarray(stats["jax"]),
                               rtol=1e-10, atol=1e-10)


def test_statistics_initialize_through_the_integrator(rp_models):
    """``initialize`` spins the ensemble up through the port's integrator
    (random states from ``rng``) and keeps its initial conditions."""
    _, model = rp_models
    integ = RungeKuttaIntegrator()
    integ.set_func(model.f)
    st = TrajectoriesStatistics()
    st.set_integrator(integ)
    st.initialize(1., 0.1, number_of_trajectories=3,
                  rng=np.random.default_rng(0))
    assert st.get_ic() is integ.ic and st.get_ic().shape == (3, model.ndim)
    st.set_func_list([lambda tr: tr[:, 0, -1]])
    out = st.compute_stats(0., 1., 0.1, num=3)
    assert out.shape == (1,) and bool(torch.isfinite(out).all())
    assert torch.equal(st.get_stats(), out)
