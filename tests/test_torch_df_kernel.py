"""The fused double-float RK4 kernel's wrapper: on the CPU it runs the plain
version and launches nothing; on a CUDA card (marked ``cuda``) the kernel
is held against its plain version."""

import numpy as np
import pytest
import torch

from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu_torch.integrators.rk import integrate_runge_kutta_df, time_grid
from qgs_tpu_torch.ops import fused_df_rk4
from qgs_tpu_torch.ops.twofloat import DfTendency, df_from_f64, df_to_f64

from tests.test_trajectory import _maooam_params

TOL = dict(rtol=1e-9, atol=1e-11)


@pytest.fixture(scope="module")
def maooam():
    pars = _maooam_params()
    _, _, qgt = jax_create_tendencies(pars, return_qgtensor=True)
    return pars, qgt.tensor


def _port(tensor, device="cpu"):
    return DfTendency(tensor.coords, tensor.data, tensor.shape, device=device)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing(maooam):
    pars, tensor = maooam
    f = _port(tensor)
    y = df_from_f64(torch.as_tensor(
        np.random.default_rng(7).random((3, pars.ndim)) * 0.01))
    dts = torch.full((12,), 0.1, dtype=torch.float64)
    before = fused_df_rk4.launches
    out, rec = fused_df_rk4.fused_df_rk4(f, *y, dts, 5)
    out_ref, rec_ref = fused_df_rk4.fused_df_rk4_reference(f, *y, dts, 5)
    assert fused_df_rk4.launches == before == 0
    for a, b in zip(out + rec, out_ref + rec_ref):
        assert torch.equal(a, b)
    assert rec[0].shape == rec[1].shape == (2, 3, pars.ndim)
    assert not torch.equal(out[0], y[0])          # the input is not modified
    _, (eh, el) = fused_df_rk4.fused_df_rk4(f, *y, dts[:4], 0)
    assert eh.shape == el.shape == (0, 3, pars.ndim)


def test_cpu_integration_records_like_the_kernel_route(maooam):
    """On the CPU ``integrate_runge_kutta_df`` runs the plain step loop; its
    records equal the plain version's, with the initial and the shorter
    last step's state added."""
    pars, tensor = maooam
    f = _port(tensor)
    x = np.random.default_rng(8).random((2, pars.ndim)) * 0.01
    y0 = df_from_f64(torch.as_tensor(x))
    grid = time_grid(0., 3.05, 0.1)
    t, traj = integrate_runge_kutta_df(f, 0., 3.05, 0.1, x, write_steps=7)
    final, (rh, rl) = fused_df_rk4.fused_df_rk4_reference(f, *y0,
                                                          np.diff(grid), 7)
    assert fused_df_rk4.launches == 0
    assert traj.dtype == torch.float64 and traj.shape == (2, pars.ndim, 6)
    assert np.array_equal(t, grid[[0, 7, 14, 21, 28, 31]])
    assert torch.equal(traj[..., 0], df_to_f64(y0))
    assert torch.equal(traj[..., 1:-1], df_to_f64((rh, rl)).movedim(0, -1))
    assert torch.equal(traj[..., -1], df_to_f64(final))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused double-float RK4 kernel "
                    "has no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(maooam, cuda_device):
    """B = 1000 (a ragged last block), the reference's grid with a shorter
    last step (301 steps), a record every 7 steps."""
    pars, tensor = maooam
    f = _port(tensor, cuda_device)
    dts = torch.as_tensor(np.diff(time_grid(0., 30.05, 0.1)),
                          device=cuda_device)
    assert dts.numel() == 301
    y = df_from_f64(torch.as_tensor(
        np.random.default_rng(1).random((1000, pars.ndim)) * 0.01,
        device=cuda_device))
    before = fused_df_rk4.launches
    out, rec = fused_df_rk4.fused_df_rk4(f, *y, dts, 7)
    torch.cuda.synchronize()
    assert fused_df_rk4.launches == before + 1
    out_ref, rec_ref = fused_df_rk4.fused_df_rk4_reference(f, *y, dts, 7)
    assert rec[0].shape == (43, 1000, pars.ndim)
    np.testing.assert_allclose(df_to_f64(out).cpu().numpy(),
                               df_to_f64(out_ref).cpu().numpy(), **TOL)
    np.testing.assert_allclose(df_to_f64(rec).cpu().numpy(),
                               df_to_f64(rec_ref).cpu().numpy(), **TOL)
