"""The two-layer channel atmosphere alone, and a random rank-3 tensor, on
the port's normal path against the benchmark's plain reference.

The benchmark's ``atm600`` configuration (qgs's two-layer quasi-geostrophic
atmosphere in a beta-plane channel at 12x12 modes, ndim 600) runs on the
card through K1's single-buffer streamed variant.  Its block of
parameters, cut here to 4x4 modes (ndim 72), builds the port's tendency
in a fraction of a second; the port's tensor equals the JAX package's, and
``RungeKuttaIntegrator.integrate`` of an ensemble (on the CPU the plain
step loop) agrees with ``portbench/reference/qg.py`` (``Quadratic`` and
``integrate``, plain torch) at 1e-12 of each variable's largest value:
the two sum the same terms in another order, and over 100 steps of this
model rounding grows far less than that.  A seeded random rank-3 tensor
(dense enough that rows hold many entries) is held to the same.  The
ndim-600 tensor itself is not built here (about two minutes and several
GB of host memory): each run of the benchmark's cell compares it with the
frozen one."""

import copy

import numpy as np
import pytest
import torch

from portbench.harness import checks, loader
from portbench.harness.qgconfig import build_params
from portbench.reference import qg
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu.params.params import QgParams as JaxQgParams
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops.contraction import Tendency
from qgs_tpu_torch.params.params import QgParams

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def atmosphere_block(nx, ny):
    """The ``atm600`` configuration's block of parameters at nx x ny
    channel modes."""
    block = copy.deepcopy(loader.config("atm600")["qgparams"])
    assert block["calls"][0][0] == "set_atmospheric_channel_fourier_modes"
    block["calls"][0][1] = [nx, ny]
    return block


def random_tensor(n1, nnz, seed):
    """A seeded random rank-3 COO tensor of first dimension n1: every
    variable damped, and ``nnz`` random linear and quadratic terms."""
    rng = np.random.default_rng(seed)
    i = np.arange(1, n1)
    coords = np.concatenate([
        np.stack([i, i, np.zeros_like(i)]),
        np.stack([rng.integers(1, n1, nnz), rng.integers(0, n1, nnz),
                  rng.integers(0, n1, nnz)])], axis=1)
    data = np.concatenate([np.full(n1 - 1, -1.0),
                           rng.standard_normal(nnz)])
    return qg.FrozenTensor(coords, data, (n1,) * 3)


def integrate_both(f, tensor, ic, t1, dt, write_steps):
    integrator = RungeKuttaIntegrator()
    integrator.set_func(f)
    integrator.integrate(0., t1, dt, ic=ic, write_steps=write_steps)
    _, traj = integrator.get_trajectories()
    ref = qg.integrate(qg.Quadratic(tensor), ic, 0., t1, dt, write_steps)
    return traj, ref


def test_atmosphere_4x4_against_the_reference():
    pars = build_params(QgParams, atmosphere_block(4, 4))
    assert pars.ndim == 72
    f, _, qgt = create_tendencies(pars, return_qgtensor=True, device="cpu")
    jax_pars = build_params(JaxQgParams, atmosphere_block(4, 4))
    jax_t = jax_create_tendencies(jax_pars, return_qgtensor=True)[2].tensor
    tensor = qg.FrozenTensor(np.asarray(qgt.tensor.coords),
                             np.asarray(qgt.tensor.data), (73,) * 3)
    assert checks.tensor_gap(tensor.coords, tensor.data,
                             np.asarray(jax_t.coords),
                             np.asarray(jax_t.data)) <= TOL
    ic = np.random.default_rng(72).random((16, 72)) * 0.01
    traj, ref = integrate_both(f, tensor, ic, 0.5, 0.005, 10)
    assert traj.shape == ref.shape == (16, 72, 11)
    assert checks.var_gap(traj, ref) <= TOL
    assert float((ref[..., -1] - ref[..., 0]).abs().max()) > 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_random_tensor_against_the_reference(seed):
    tensor = random_tensor(41, 2000, seed)
    f = Tendency(tensor.coords, tensor.data, tensor.shape, device="cpu")
    ic = np.random.default_rng(seed + 41).random((8, 40)) * 0.1
    traj, ref = integrate_both(f, tensor, ic, 1.0, 0.01, 20)
    assert traj.shape == ref.shape == (8, 40, 6)
    assert checks.var_gap(traj, ref) <= TOL
    assert torch.isfinite(ref).all()
