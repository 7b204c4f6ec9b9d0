"""Models whose kernel layout exceeds one block's shared memory.

The resident fused RK4 kernels (K1 ``csrc/rk4_fused.cu``, K2
``csrc/rk4_df_fused.cu``) hold a tensor's whole layout in one block's
shared memory.  A tendency's launch plan decides before any launch whether
it fits (``launch_plan(...).kernel``, from the Python twins of the
launchers' ``smem_bytes`` / ``df_smem_bytes``); a model that does not fit
runs in the streamed
kernels (``csrc/rk4_streamed.cu``, ``csrc/rk4_df_streamed.cu``, which keep
the records in device memory; ``tests/test_torch_streamed.py``), and only
a model past their limit takes the plain step loop.

* The twins' bytes and the fit decisions for MAOOAM at 2x2/2x4 (ndim 36),
  4x4/4x4 (ndim 104) and 6x6/6x6 (ndim 228) against the H100's opt-in
  limit of 232,448 bytes, passed explicitly, for two parameter sets:
  ``QgParams``' own defaults, and the MAOOAM settings of
  ``benchmarks/resolution_sweep.py``.
* ``row_groups``, the assignment both the layout and the size check use,
  gives ``group_layout``'s own tables.
* The port's ``RungeKuttaIntegrator`` against the JAX package's float64
  integrator at ndim 104 (twofloat and float64) and ndim 228 (float64): B
  = 4, 20 steps of dt 0.1, numpy-seeded states, rtol 1e-12 and atol 1e-14
  (20 steps leave only the summation order's rounding).  The JAX
  package's own twofloat runs on XLA:CPU with its error-free
  transformations' barriers stripped, about 1e-10 from float64 here, so
  the twofloat tier is held against float64, as in
  ``tests/test_torch_twofloat.py``.
* On the card (``cuda``-marked, skipped without one): those models
  integrated on the card against the CPU with the four kernels' launches
  counted, the resident kernels forced on layouts that do not fit
  raising, and a synthetic tensor past the streamed kernels' float64
  limit (n1 = 600) raising in float64 and twofloat.
"""

import numpy as np
import pytest
import torch

from qgs_tpu.integrators.integrator import (
    RungeKuttaIntegrator as JaxRungeKuttaIntegrator,
)
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.integrators.rk import (fused_route, rk2_tableau,
                                          rk4_tableau)
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops import _build, fused_df_rk4, fused_rk4
from qgs_tpu_torch.ops.contraction import Tendency
from qgs_tpu_torch.ops.twofloat import DfTendency, df_from_f64

from tests.test_torch_host import both_params

H100_OPTIN = 232448        # cudaDevAttrMaxSharedMemoryPerBlockOptin, H100
TOL = dict(rtol=1e-12, atol=1e-14)     # the port against the JAX package
# the card against the CPU: float64 and twofloat trajectories
# (tests/test_trajectory.py:57), and float32 ones
TOL64 = dict(rtol=1e-9, atol=1e-11)
TOL32 = dict(rtol=1e-4, atol=1e-6)

BLOCKS = {36: ((2, 2), (2, 4)), 104: ((4, 4), (4, 4)), 228: ((6, 6), (6, 6))}


def defaults(ndim):
    """MAOOAM on ``QgParams``' own defaults at the given width."""
    def settings(QgParams):
        pars = QgParams()
        pars.set_atmospheric_channel_fourier_modes(*BLOCKS[ndim][0])
        pars.set_oceanic_basin_fourier_modes(*BLOCKS[ndim][1])
        return pars
    return settings


def sweep(ndim):
    """MAOOAM with the settings of ``benchmarks/resolution_sweep.py:94-104``
    (those of ``qgs_maooam.py``) at the given width."""
    def settings(QgParams):
        pars = defaults(ndim)(QgParams)
        pars.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5, 'r': 1.e-7,
                         'h': 136.5, 'd': 1.1e-7})
        pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3,
                                             'hlambda': 15.06})
        pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
        pars.atemperature_params.set_insolation(103.3333, 0)
        pars.gotemperature_params.set_insolation(310., 0)
        return pars
    return settings


# (settings, ndim) -> (nnz, layout width at G = 8, K1 float64 bytes, K2
# bytes); K1 float64 / float32 / K2 fit under the H100's limit
TABLE = {
    ("defaults", 36): (351, 50, 43776, 56192),
    ("defaults", 104): (4935, 630, 187648, 254592),
    ("defaults", 228): (27811, 3506, 682752, 965504),
    ("sweep", 36): (351, 50, 43776, 56192),
    ("sweep", 104): (4919, 628, 187392, 254208),
    ("sweep", 228): (27762, 3500, 681984, 964352),
}
FITS = {36: (True, True, True), 104: (True, True, False),
        228: (False, False, False)}
SETTINGS = {"defaults": defaults, "sweep": sweep}


def synthetic(n1, dtype=torch.float64, device="cpu"):
    """A cheap rank-3 tendency of first dimension ``n1``: every variable
    damped, and driven by the product of its two neighbours."""
    i = np.arange(1, n1)
    j = np.where(i > 1, i - 1, n1 - 1)
    k = np.where(i < n1 - 1, i + 1, 1)
    coords = np.concatenate([np.stack([i, i, np.zeros_like(i)]),
                             np.stack([i, j, k])], axis=1)
    data = np.concatenate([np.full(n1 - 1, -0.01), np.full(n1 - 1, 0.1)])
    return Tendency(coords, data, (n1,) * 3, dtype=dtype, device=device)


_tendencies = {}


def port_tendency(name, ndim):
    """The port's batched float64 tendency on the CPU (built once)."""
    if (name, ndim) not in _tendencies:
        pars = SETTINGS[name](ndim)(QgParams)
        _tendencies[name, ndim] = create_tendencies(pars,
                                                    device="cpu")[0].batched
    return _tendencies[name, ndim]


@pytest.mark.parametrize("case", list(TABLE), ids=lambda c: f"{c[0]}-{c[1]}")
def test_twins_give_the_launchers_bytes(case):
    nnz, width, k1, k2 = TABLE[case]
    f = port_tendency(*case)
    n1 = f.shape[0]
    assert n1 == case[1] + 1 and len(f.data) == nnz
    assert fused_rk4.row_groups(f.coords, n1, 8).width == width
    assert fused_rk4.smem_bytes(n1, 8, width, torch.float64) == k1
    assert fused_df_rk4.df_smem_bytes(n1, 8, width) == k2
    # float32 state rows are half as wide; the records are 16 bytes either
    assert (fused_rk4.smem_bytes(n1, 8, width, torch.float32)
            == k1 - 4 * (4 * case[1] + 2) * 32)


def resident(f, family, dtype, limit=H100_OPTIN):
    """Whether ``f``'s launch plan of ``family`` takes the resident
    kernel."""
    return fused_rk4.launch_plan(f, family, dtype, "cuda",
                                 limit=limit).kernel == "resident"


@pytest.mark.parametrize("case", list(TABLE), ids=lambda c: f"{c[0]}-{c[1]}")
def test_fit_decisions(case):
    f = port_tendency(*case)
    got = (resident(f, fused_rk4.K1, torch.float64),
           resident(f, fused_rk4.K1, torch.float32),
           resident(f, fused_df_rk4.DF, torch.float32))
    assert got == FITS[case[1]]
    # the bound is inclusive, and the plan's G is the kernels' 8
    need = fused_rk4.smem_bytes(f.shape[0], 8, TABLE[case][1], torch.float64)
    assert resident(f, fused_rk4.K1, torch.float64, need)
    assert not resident(f, fused_rk4.K1, torch.float64, need - 1)
    assert fused_rk4.K1.groups == fused_df_rk4.DF.groups == 8


def _argmin_assignment(padded, groups):
    """The assignment rule written out plainly: rows longest first (stable),
    each to the first group of least load."""
    load = np.zeros(groups, np.int64)
    out = np.empty(len(padded), np.int64)
    for i in np.argsort(-padded, kind="stable"):
        g = int(np.argmin(load))
        out[i] = g
        load[g] += padded[i]
    return out, load


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("ndim", [36, 104])
def test_row_groups_is_group_layouts_assignment(ndim, groups):
    f = port_tendency("sweep", ndim)
    rg = fused_rk4.row_groups(f.coords, f.shape[0], groups)
    layout = fused_rk4.group_layout(f.coords, f.data, f.shape, groups)
    assert layout.jk.shape == (groups, rg.width)
    assert np.array_equal(layout.lengths, rg.load)
    assert np.array_equal(layout.group_of_row, rg.group_of_row)
    group_of_row, load = _argmin_assignment(rg.padded, groups)
    assert np.array_equal(rg.group_of_row, group_of_row)
    assert np.array_equal(rg.load, load)
    assert rg.width == load.max() + fused_rk4.AHEAD * fused_rk4.CHUNK


def test_twins_refuse_other_dtypes_and_devices():
    f = port_tendency("sweep", 36)
    with pytest.raises(TypeError, match="float32 or float64"):
        resident(f, fused_rk4.K1, torch.float16)
    with pytest.raises(TypeError, match="float32"):
        resident(f, fused_df_rk4.DF, torch.float64)
    with pytest.raises(ValueError, match="CUDA cards"):
        _build.max_smem_optin("cpu")


class _OnCard:
    """A stand-in state of ``dtype`` that reports a CUDA device."""
    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, dtype):
        self.dtype = dtype


@pytest.mark.parametrize("ndim", [36, 104, 228])
def test_route_follows_the_fit(ndim, monkeypatch):
    """``fused_route`` on a card whose opt-in limit is the H100's (a
    stand-in state and limit: there is no card here): K1's family for
    float64 and K2's for twofloat at every width, their launch plans taking
    the resident kernel where its layout fits and the streamed one past it,
    and only for classical RK4."""
    monkeypatch.setattr(_build, "max_smem_optin", lambda device: H100_OPTIN)
    f = port_tendency("sweep", ndim)
    fdf = DfTendency(f.coords, f.data, f.shape, device="cpu")
    pair = (_OnCard(torch.float32), _OnCard(torch.float32))
    k1, _, k2 = FITS[ndim]
    assert fused_route(f, _OnCard(torch.float64), rk4_tableau()) is \
        fused_rk4.K1
    assert fused_route(fdf, pair, rk4_tableau()) is fused_df_rk4.DF
    assert fused_rk4.launch_plan(f, fused_rk4.K1, torch.float64,
                                 "cuda").kernel == (
        "resident" if k1 else "streamed")
    assert fused_rk4.launch_plan(fdf, fused_df_rk4.DF, torch.float32,
                                 "cuda").kernel == (
        "resident" if k2 else "streamed")
    assert fused_route(f, _OnCard(torch.float64), rk2_tableau()) is None


def test_cpu_states_take_the_plain_loop():
    f = port_tendency("sweep", 36)
    y = torch.zeros((2, 36), dtype=torch.float64)
    assert fused_route(f, y, rk4_tableau()) is None
    fdf = DfTendency(f.coords, f.data, f.shape, device="cpu")
    assert fused_route(fdf, df_from_f64(y), rk4_tableau()) is None


_jax_runs = {}


def _integrate(cls, f, ic, precision):
    integrator = cls(precision=precision)
    integrator.set_func(f)
    integrator.integrate(0., 2., 0.1, ic=ic, write_steps=5)
    t, traj = integrator.get_trajectories()
    return np.asarray(t), np.asarray(traj)


@pytest.mark.parametrize("ndim, precision", [(104, "twofloat"),
                                             (104, "float64"),
                                             (228, "float64")])
def test_integrator_matches_jax(ndim, precision):
    jax_pars, pars = both_params(sweep(ndim))
    ic = np.random.default_rng(ndim).random((4, pars.ndim)) * 0.01
    if ndim not in _jax_runs:
        f_jax, _ = jax_create_tendencies(jax_pars)
        _jax_runs[ndim] = _integrate(JaxRungeKuttaIntegrator, f_jax, ic,
                                     "float64")
    t_j, y_j = _jax_runs[ndim]
    f_port, _ = create_tendencies(pars, device="cpu")
    t_p, y_p = _integrate(RungeKuttaIntegrator, f_port, ic, precision)
    assert np.array_equal(t_p, t_j) and y_p.shape == (4, ndim, 5)
    np.testing.assert_allclose(y_p, y_j, **TOL)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the route depends on the card's "
                    "shared memory, and the kernels have no CPU build")
    return torch.device("cuda", 0)


def launch_counts():
    """The launches of K1, K2 and their streamed counterparts so far."""
    return (fused_rk4.launches, fused_df_rk4.launches,
            fused_rk4.launches_streamed, fused_df_rk4.launches_streamed)


@pytest.mark.cuda
@pytest.mark.parametrize("ndim, precision, kernels", [
    (104, "float64", (1, 0, 0, 0)), (104, "float32", (1, 0, 0, 0)),
    (104, "twofloat", (0, 0, 0, 1)), (228, "float64", (0, 0, 1, 0))])
def test_card_against_cpu(cuda_device, ndim, precision, kernels):
    pars = sweep(ndim)(QgParams)
    ic = np.random.default_rng(ndim).random((64, pars.ndim)) * 0.01
    f_cpu, _ = create_tendencies(pars, device="cpu")
    _, ref = _integrate(RungeKuttaIntegrator, f_cpu, ic,
                        "twofloat" if precision == "twofloat" else "float64")
    dtype = torch.float32 if precision == "float32" else torch.float64
    f_card, _ = create_tendencies(pars, dtype=dtype, device=cuda_device)
    before = launch_counts()
    integrator = RungeKuttaIntegrator(
        precision="twofloat" if precision == "twofloat" else "float64")
    integrator.set_func(f_card)
    integrator.integrate(0., 2., 0.1, ic=ic, write_steps=5)
    _, traj = integrator.get_trajectories()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(launch_counts(), before)) == kernels
    np.testing.assert_allclose(traj.double().cpu().numpy(), ref,
                               **(TOL32 if precision == "float32" else TOL64))


@pytest.mark.cuda
def test_direct_launches_that_do_not_fit_raise(cuda_device):
    """The resident kernels forced on layouts that do not fit raise, and a
    tensor past every kernel's float64 limit (n1 = 845, past K1's
    single-buffer variant) raises in float64 and twofloat; no refused
    launch is counted."""
    before = launch_counts()
    f104 = port_tendency("sweep", 104)
    fdf = DfTendency(f104.coords, f104.data, f104.shape, device=cuda_device)
    y = df_from_f64(torch.zeros((32, 104), dtype=torch.float64,
                                device=cuda_device))
    dts = torch.full((4,), 0.1, dtype=torch.float64, device=cuda_device)
    assert not resident(fdf, fused_df_rk4.DF, torch.float32, None)
    with pytest.raises(RuntimeError, match="rk4_df_fused launch failed"):
        fused_df_rk4.DF.launch(fdf, y, dts, kernel="resident")
    f228, _ = create_tendencies(sweep(228)(QgParams), device=cuda_device)
    y = torch.zeros((32, 228), dtype=torch.float64, device=cuda_device)
    assert not resident(f228.batched, fused_rk4.K1, torch.float64, None)
    with pytest.raises(RuntimeError, match="rk4_fused launch failed"):
        fused_rk4.K1.launch(f228.batched, y, dts, kernel="resident")
    big = synthetic(845, device=cuda_device)
    big_df = DfTendency(big.coords, big.data, big.shape, device=cuda_device)
    y = torch.zeros((32, 844), dtype=torch.float64, device=cuda_device)
    assert fused_rk4.launch_plan(big, fused_rk4.K1, torch.float64,
                                 cuda_device).kernel is None
    assert fused_route(big, y, rk4_tableau()) is None
    with pytest.raises(RuntimeError, match="neither the resident"):
        fused_rk4.fused_rk4(big, y, dts)
    with pytest.raises(RuntimeError, match="neither the resident"):
        fused_df_rk4.fused_df_rk4(big_df, *df_from_f64(y), dts)
    assert launch_counts() == before
