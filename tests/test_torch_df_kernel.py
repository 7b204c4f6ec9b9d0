"""The fused double-float RK4 kernel's wrapper and layout: the tendency
through the kernel's row-group layout in the kernel's order
(``df_group_tendency``) against ``DfTendency`` and eager JAX double-float,
for every choice of G the layout is checked at; a double-float product by
``xx[0] = (1, 0)``
returns its other factor bit for bit; on the CPU the wrapper runs the
plain version and launches nothing; on a CUDA card (marked ``cuda``) the
kernel is held against its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu.ops import twofloat as jtf
from qgs_tpu_torch.integrators.rk import integrate_runge_kutta_df, time_grid
from qgs_tpu_torch.ops import fused_df_rk4, fused_rk4
from qgs_tpu_torch.ops.twofloat import (DfTendency, df_from_f64, df_mul,
                                        df_to_f64, quick_two_sum,
                                        split_values)

from tests.test_torch_twofloat import _maooam_4x4_params
from tests.test_trajectory import _maooam_params

TOL = dict(rtol=1e-9, atol=1e-11)
LAYOUT_GROUPS = (1, 2, 4, 8)     # the G the layout is checked at


@pytest.fixture(scope="module")
def maooam():
    pars = _maooam_params()
    _, _, qgt = jax_create_tendencies(pars, return_qgtensor=True)
    return pars, qgt.tensor


def _port(tensor, device="cpu"):
    return DfTendency(tensor.coords, tensor.data, tensor.shape, device=device)


def _bits(pair):
    return tuple(p.contiguous().view(torch.int32) for p in pair)


@pytest.fixture(scope="module",
                params=[_maooam_params, _maooam_4x4_params],
                ids=["maooam", "maooam_4x4"])
def config(request):
    """A configuration's tensor, a seeded (4, ndim) double-float state and
    the eager JAX ``make_df_quadratic(accumulate='strict')`` tendency of
    it, as in ``tests/test_torch_twofloat.py``."""
    pars = request.param()
    _, _, qgt = jax_create_tendencies(pars, return_qgtensor=True)
    T = qgt.tensor
    x = np.random.default_rng(2).random((4, pars.ndim)) * 0.05
    xx = np.concatenate([np.ones((4, 1)), x], axis=1)
    quad = jtf.make_df_quadratic(T, accumulate="strict")
    ref = np.asarray(jtf.df_to_f64(quad(jtf.df_from_f64(jnp.asarray(xx)))))
    return T, df_from_f64(torch.as_tensor(x)), ref[:, 1:]


@pytest.mark.parametrize("groups", LAYOUT_GROUPS)
def test_df_group_tendency_matches_df_tendency_and_eager_jax(config, groups):
    """Only the summation order of a row differs: atol 1e-14, the tolerance
    of ``DfTendency`` against eager JAX."""
    T, x, ref = config
    lay = fused_rk4.group_layout(T.coords, T.data, T.shape, groups)
    out = fused_df_rk4.df_group_tendency(lay, *x)
    assert out[0].dtype == out[1].dtype == torch.float32
    assert out[0].shape == out[1].shape == x[0].shape
    np.testing.assert_allclose(df_to_f64(out).numpy(),
                               df_to_f64(_port(T)(*x)).numpy(), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(df_to_f64(out).numpy(), ref, rtol=0,
                               atol=1e-14)


def test_df_mul_by_unit_returns_the_tensor_values(config):
    """``df_mul(v, (1, 0)) == v`` bit for bit for every (hi, lo) split of
    the tensor's values: a kernel that skipped ``v * xx[0]`` would change
    nothing."""
    T, _, _ = config
    v = tuple(torch.as_tensor(p) for p in split_values(T.data))
    unit = (torch.ones_like(v[0]), torch.zeros_like(v[1]))
    for got, want in zip(_bits(df_mul(v, unit)), _bits(v)):
        assert torch.equal(got, want)


def test_df_mul_by_unit_returns_quick_two_sum_outputs():
    """The same for the normalised pairs that every df op returns (the
    stage inputs and partial products that meet a factor (1, 0))."""
    rng = np.random.default_rng(9)
    a = torch.as_tensor(rng.standard_normal(1 << 16), dtype=torch.float32)
    b = a * torch.as_tensor(rng.uniform(-1, 1, 1 << 16) * 1e-3,
                            dtype=torch.float32)
    t = quick_two_sum(a, b)
    assert (t[1] != 0).float().mean() > 0.9
    unit = (torch.ones_like(a), torch.zeros_like(a))
    for got, want in zip(_bits(df_mul(t, unit)), _bits(t)):
        assert torch.equal(got, want)


def test_df_group_tendency_writes_rows_without_entries():
    """A row without entries (its one chunk of zero records) gets 0, and a
    group without rows (G above the row count) is skipped."""
    coords = np.array([[1, 1, 3, 3, 3], [0, 1, 2, 3, 0], [1, 1, 3, 0, 0]])
    data = np.array([1., 2., 3., 4., 5.])
    x = df_from_f64(torch.tensor([[0.5, -2., 3.]], dtype=torch.float64))
    ref = DfTendency(coords, data, (4, 4, 4), device="cpu")(*x)
    for groups in LAYOUT_GROUPS:
        lay = fused_rk4.group_layout(coords, data, (4, 4, 4), groups)
        out = fused_df_rk4.df_group_tendency(lay, *x)
        assert torch.equal(df_to_f64(out), df_to_f64(ref))
        assert out[0][0, 1] == out[1][0, 1] == 0


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
@pytest.mark.parametrize("B", [1, 31, 1000])
def test_kernel_matches_plain_version_on_card(maooam, cuda_device, B):
    """Full and ragged blocks (B = 1000 has a ragged last block), the
    reference's grid with a shorter last step (301 steps), a record every 7
    steps."""
    pars, tensor = maooam
    f = _port(tensor, cuda_device)
    dts = torch.as_tensor(np.diff(time_grid(0., 30.05, 0.1)),
                          device=cuda_device)
    assert dts.numel() == 301
    y = df_from_f64(torch.as_tensor(
        np.random.default_rng(B).random((B, pars.ndim)) * 0.01,
        device=cuda_device))
    before = fused_df_rk4.launches
    out, rec = fused_df_rk4.fused_df_rk4(f, *y, dts, 7)
    torch.cuda.synchronize()
    assert fused_df_rk4.launches == before + 1
    out_ref, rec_ref = fused_df_rk4.fused_df_rk4_reference(f, *y, dts, 7)
    assert rec[0].shape == (43, B, pars.ndim)
    np.testing.assert_allclose(df_to_f64(out).cpu().numpy(),
                               df_to_f64(out_ref).cpu().numpy(), **TOL)
    np.testing.assert_allclose(df_to_f64(rec).cpu().numpy(),
                               df_to_f64(rec_ref).cpu().numpy(), **TOL)
