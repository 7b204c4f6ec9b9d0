"""The port's drivers ``qgs_tpu_torch.drivers.qgs_maooam`` and
``qgs_tpu_torch.drivers.qgs_rp`` on the CPU at short times, on a mesh that
names the CPU twice: the trajectories they return and write against the
same sequence built from the JAX package (``QgParams``,
``create_tendencies``, ``RungeKuttaIntegrator`` on its 8 virtual devices)
from the same ``RandomState`` draws as the repository's ``qgs_maooam.py``
and ``qgs_rp.py``, at PERF.md's float64 tolerance, rtol 1e-9 and atol
1e-11."""

import numpy as np
import pytest
import torch

from qgs_tpu.integrators.integrator import (
    RungeKuttaIntegrator as JaxIntegrator,
)
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu.params.params import QgParams as JaxQgParams
from qgs_tpu_torch.drivers import qgs_maooam, qgs_rp
from qgs_tpu_torch.parallel.mesh import ensemble_mesh

from tests.test_torch_host import maooam, rp

TOL = dict(rtol=1e-9, atol=1e-11)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: one intra-op thread (see ``test_torch_lyapunov.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run(pars, ic, dt, transient, evolution, write_steps):
    """The drivers' sequence in the JAX package: a transient, then the
    evolution from its last state."""
    f, _ = jax_create_tendencies(pars)
    integ = JaxIntegrator()
    integ.set_func(f)
    integ.integrate(0., transient, dt, ic=ic, write_steps=0)
    _, y = integ.get_trajectories()
    integ.integrate(0., evolution, dt, ic=y, write_steps=write_steps)
    t, traj = integ.get_trajectories()
    return np.asarray(t), np.asarray(traj)


@pytest.mark.parametrize("ensemble", [1, 4])
def test_maooam_driver_matches_jax(tmp_path, monkeypatch, capsys, ensemble):
    """MAOOAM, transient 20 and evolution 10 time units, a record every 10
    steps; one member (text file of times and the trajectory) or four
    (``QGS_ENSEMBLE=4``, a .npy of (4, 36, 11), split over two entries)."""
    monkeypatch.setenv("QGS_ENSEMBLE", str(ensemble))
    filename = str(tmp_path / "evol_fields.dat")
    t, traj = qgs_maooam.main(transient_time=20., integration_time=10.,
                              write_steps=10, filename=filename,
                              mesh=ensemble_mesh(["cpu"] * 2), device="cpu")
    out = capsys.readouterr().out
    assert "Starting the time evolution" in out and "Time clock" in out

    rng = np.random.RandomState(210217)
    ic = rng.rand(36) * 0.01
    if ensemble > 1:
        ic = ic[None, :] + 1e-4 * rng.randn(ensemble, 36)
    t_j, traj_j = _jax_run(maooam(JaxQgParams), ic, 0.1, 20., 10., 10)
    assert np.array_equal(t, t_j)
    assert traj.shape == traj_j.shape == ((36, 11) if ensemble == 1
                                          else (4, 36, 11))
    np.testing.assert_allclose(traj, traj_j, **TOL)

    if ensemble == 1:
        written = np.loadtxt(filename)
        assert written.shape == (11, 37)
        np.testing.assert_allclose(written, np.concatenate(
            [t[None, :], traj]).T, rtol=1e-15, atol=0)
    else:
        written = np.load(str(tmp_path / "evol_fields.npy"))
        assert np.array_equal(written, traj)
    assert np.isfinite(written).all()


def test_rp_driver_matches_jax(tmp_path, capsys):
    """RP, transient 50 and evolution 5 time units, a record every 5
    steps: 11 records of 20 variables written as text."""
    filename = str(tmp_path / "evol_fields.dat")
    t, traj = qgs_rp.main(transient_time=50., integration_time=5.,
                          filename=filename, mesh=ensemble_mesh(["cpu"] * 2),
                          device="cpu")
    assert "Time clock" in capsys.readouterr().out
    ic = np.random.RandomState(21217).rand(20) * 0.1
    t_j, traj_j = _jax_run(rp(JaxQgParams), ic, 0.1, 50., 5., 5)
    assert np.array_equal(t, t_j) and traj.shape == (20, 11)
    np.testing.assert_allclose(traj, traj_j, **TOL)
    written = np.loadtxt(filename)
    assert written.shape == (11, 21) and np.isfinite(written).all()
    np.testing.assert_allclose(written[:, 1:], traj.T, rtol=1e-15, atol=0)


def test_random_draws_are_the_seeded_scripts():
    """``RandomState(seed)`` draws what ``np.random.seed(seed)`` followed by
    ``np.random.rand``/``randn`` draws in the repository's scripts."""
    state = np.random.get_state()
    try:
        np.random.seed(210217)
        a = np.random.rand(36), np.random.randn(4, 36)
    finally:
        np.random.set_state(state)
    rng = np.random.RandomState(210217)
    b = rng.rand(36), rng.randn(4, 36)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
