"""The port's diagnostics (``qgs_tpu_torch.diagnostics``) against the JAX
package's on the CPU: the same seeded trajectory, integrated by the JAX
package, goes through each class of the catalog in both packages, for the
RP, MAOOAM, ground-coupled and dynamic-T (ndim 38) configurations and both
``dimensional`` settings.  Only the order of summation in the products
differs, so the limit is rtol 1e-12 and atol 1e-12 x max|reference|; the
host grids ``X, Y`` must be equal bit for bit.

Also: every kind of input (a NumPy array, a float64 and a float32 tensor,
the port's own ``get_trajectories`` output), the plots on Agg with tensor
data, the default device, and the card against the CPU."""

import numpy as np
import pytest
import torch

from qgs_tpu.diagnostics import base as jax_base
from qgs_tpu.diagnostics import eddy as jax_eddy
from qgs_tpu.diagnostics import multi as jax_multi
from qgs_tpu.diagnostics import streamfunctions as jax_streamfunctions
from qgs_tpu.diagnostics import temperatures as jax_temperatures
from qgs_tpu.diagnostics import variables as jax_variables
from qgs_tpu.diagnostics import vorticity as jax_vorticity
from qgs_tpu.diagnostics import wind as jax_wind
from qgs_tpu.integrators.integrator import (
    RungeKuttaIntegrator as JaxRungeKuttaIntegrator,
)
from qgs_tpu.models.tendencies import (
    create_atmo_thermo_tendencies as jax_create_atmo_thermo_tendencies,
    create_tendencies as jax_create_tendencies,
)
from qgs_tpu_torch.diagnostics import (base, eddy, multi, streamfunctions,
                                       temperatures, variables, vorticity,
                                       wind)
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.models.tendencies import create_tendencies

from tests.test_torch_host import both_params, dynamic_t, ground, maooam, rp

RTOL = 1e-12
GRID = dict(delta_x=0.3, delta_y=0.3)      # a coarse grid for the sweep
CONFIGS = {"rp": rp, "maooam": maooam, "ground": ground, "dynT": dynamic_t}
MODULES = {"streamfunctions": (jax_streamfunctions, streamfunctions),
           "temperatures": (jax_temperatures, temperatures),
           "wind": (jax_wind, wind), "vorticity": (jax_vorticity, vorticity),
           "eddy": (jax_eddy, eddy)}

# (module, class, extra keywords) of each field or profile diagnostic
ATMOSPHERE = [
    ("streamfunctions", "LowerLayerAtmosphericStreamfunctionDiagnostic", {}),
    ("streamfunctions", "UpperLayerAtmosphericStreamfunctionDiagnostic", {}),
    ("streamfunctions", "MiddleAtmosphericStreamfunctionDiagnostic", {}),
    ("streamfunctions", "MiddleAtmosphericStreamfunctionDiagnostic",
     {"geopotential": True}),
    ("temperatures", "MiddleAtmosphericTemperatureAnomalyDiagnostic", {}),
    ("temperatures", "MiddleAtmosphericTemperatureDiagnostic", {}),
    ("temperatures", "AtmosphericTemperatureMeridionalGradientDiagnostic", {}),
    ("temperatures",
     "MiddleAtmosphericTemperatureMeridionalGradientDiagnostic", {}),
    ("wind", "LowerLayerAtmosphericUWindDiagnostic", {}),
    ("wind", "LowerLayerAtmosphericVWindDiagnostic", {}),
    ("wind", "MiddleAtmosphericUWindDiagnostic", {}),
    ("wind", "MiddleAtmosphericVWindDiagnostic", {}),
    ("wind", "UpperLayerAtmosphericUWindDiagnostic", {}),
    ("wind", "UpperLayerAtmosphericVWindDiagnostic", {}),
    ("wind", "LowerLayerAtmosphericWindIntensityDiagnostic", {}),
    ("wind", "MiddleAtmosphericWindIntensityDiagnostic", {}),
    ("wind", "UpperLayerAtmosphericWindIntensityDiagnostic", {}),
    ("wind", "MiddleLayerVerticalVelocity", {}),
    ("vorticity", "LowerLayerAtmosphericVorticityDiagnostic", {}),
    ("vorticity", "MiddleAtmosphericVorticityDiagnostic", {}),
    ("vorticity", "UpperLayerAtmosphericVorticityDiagnostic", {}),
    ("vorticity", "UpperLayerAtmosphericPotentialVorticityDiagnostic", {}),
    ("vorticity", "LowerLayerAtmosphericPotentialVorticityDiagnostic", {}),
    ("eddy", "MiddleAtmosphericEddyHeatFluxDiagnostic", {}),
    ("eddy", "MiddleAtmosphericEddyHeatFluxProfileDiagnostic", {}),
]
OCEAN = [
    ("streamfunctions", "OceanicLayerStreamfunctionDiagnostic", {}),
    ("streamfunctions", "OceanicLayerStreamfunctionDiagnostic",
     {"conserved": False}),
    ("temperatures", "OceanicLayerTemperatureAnomalyDiagnostic", {}),
    ("temperatures", "OceanicLayerTemperatureDiagnostic", {}),
    ("vorticity", "OceanicLayerVorticityDiagnostic", {}),
]
GROUND = [
    ("temperatures", "GroundTemperatureAnomalyDiagnostic", {}),
    ("temperatures", "GroundTemperatureDiagnostic", {}),
]
CATALOG = {"rp": ATMOSPHERE, "maooam": ATMOSPHERE + OCEAN,
           "ground": ATMOSPHERE + GROUND, "dynT": ATMOSPHERE + OCEAN}
OMEGA = "MiddleLayerVerticalVelocity"


def case_id(module, name, kwargs):
    return name + "".join(f"-{k}={v}" for k, v in kwargs.items())


# omega of a dynamic-T model is held against its definition separately: the
# JAX package's raises there (see test_vertical_velocity_dynamic_t)
CASES = [pytest.param(config, entry, dim,
                      id=f"{config}-{case_id(*entry)}-{'dim' if dim else 'nondim'}")
         for config, entries in CATALOG.items() for entry in entries
         if not (config == "dynT" and entry[1] == OMEGA)
         for dim in (True, False)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread (see ``test_torch_tgls.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def initial_state(pars, seed=0):
    """A seeded initial state; a dynamic-T model starts near its
    stationary 0-th order temperatures (``tests/test_t4.py``)."""
    x = np.random.default_rng(seed).random(pars.ndim) * 0.05
    if pars.dynamic_T:
        x[pars.variables_range[0]] = 0.1
        x[pars.variables_range[2]] = 0.12
    return x


class Setup:
    """One configuration: both packages' parameters, a trajectory of the
    JAX integrator (20 time units, a record every 10 steps) and a cache of
    the diagnostics built for it, each pair built once."""

    def __init__(self, settings):
        self.jax_pars, self.pars = both_params(settings)
        f, _ = jax_create_tendencies(self.jax_pars)
        integ = JaxRungeKuttaIntegrator()
        integ.set_func(f)
        integ.integrate(0., 20., 0.1, ic=initial_state(self.jax_pars),
                        write_steps=10)
        t, traj = integ.get_trajectories()
        self.t, self.traj = np.array(t), np.array(traj, dtype=np.float64)
        self._built = {}

    def pair(self, module, name, kwargs, **grid):
        """The (JAX package's, port's) diagnostic, the port's on the CPU."""
        grid = grid or GRID
        key = (module, name, tuple(sorted(kwargs.items())),
               tuple(sorted(grid.items())))
        if key not in self._built:
            jax_mod, mod = MODULES[module]
            self._built[key] = (
                getattr(jax_mod, name)(self.jax_pars, **grid, **kwargs),
                getattr(mod, name)(self.pars, **grid, **kwargs, device="cpu"))
        return self._built[key]


@pytest.fixture(scope="module")
def setups():
    built = {}

    def get(config):
        if config not in built:
            built[config] = Setup(CONFIGS[config])
        return built[config]
    return get


def assert_matches(got, ref):
    """The port's tensor against the JAX package's array."""
    assert torch.is_tensor(got) and got.dtype == torch.float64
    assert got.device.type == "cpu"
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("config, entry, dimensional", CASES)
def test_catalog_matches_jax(setups, config, entry, dimensional):
    s = setups(config)
    jd, pd = s.pair(*entry)
    jd.dimensional = pd.dimensional = dimensional
    ref = jd(s.t, s.traj)
    got = pd(s.t, s.traj)
    assert_matches(got, ref)
    if isinstance(pd, base.FieldDiagnostic):
        for a, b in zip(pd.grid, jd.grid):
            assert np.array_equal(a, b)
        assert type(pd.grid[0]) is np.ndarray
        if jd._orography is None:
            assert pd._orography is None
        else:
            assert np.array_equal(pd._orography, jd._orography)
    assert len(pd) == len(jd) and type(len(pd)) is int
    assert pd.plot_title == jd.plot_title
    assert pd.plot_units == jd.plot_units
    np.testing.assert_array_equal(pd.time, jd.time)


@pytest.mark.parametrize("dimensional", [True, False],
                         ids=["dim", "nondim"])
def test_vertical_velocity_dynamic_t(setups, dimensional):
    """On dynamic-T (ndim 38) the JAX package's omega reconstructs the
    theta coefficients past T_a0 on every atmospheric mode grid, T_a0's
    included, and raises on the mismatch; the port's uses the theta modes'
    grids, as every other atmospheric field does.  It is held against that
    product built from the JAX package's own tendencies and grids."""
    s = setups("dynT")
    jd, pd = s.pair("wind", OMEGA, {})
    jd.dimensional = pd.dimensional = dimensional
    with pytest.raises(ValueError):
        jd(s.t, s.traj)
    jp = s.jax_pars
    f, _ = jax_create_tendencies(jp)
    f_thermo = jax_create_atmo_thermo_tendencies(jp)
    states = s.traj.T
    omega = (np.asarray(f.batched(0., states))
             - np.asarray(f_thermo.batched(0., states))).T \
        / float(jp.atmospheric_params.sig0)
    vr = jp.variables_range
    ref = jax_base.Diagnostic._reconstruct(
        None, omega[vr[0] + 1:vr[1]], jd._grid_basis[1:])
    if dimensional:
        ref = ref * float(jp.scale_params.deltap) * float(jp.scale_params.f0)
    assert_matches(pd(s.t, s.traj), ref)


@pytest.mark.parametrize("config", ["maooam", "dynT"])
def test_vertical_velocity_uses_the_port_tendencies(setups, config):
    """omega's tendencies are the port's, on the diagnostic's device, and
    its data are the (ndim, n_records) tendency difference over sigma_0."""
    s = setups(config)
    _, pd = s.pair("wind", OMEGA, {})
    assert pd._f.batched.device.type == "cpu"
    assert type(pd._f.batched).__module__.startswith("qgs_tpu_torch.")
    pd.set_data(s.t, s.traj)
    assert tuple(pd._data.shape) == s.traj.shape
    x = torch.as_tensor(s.traj[:, 3])
    expected = (pd._f(0., x) - pd._f_thermo(0., x)) \
        / float(s.pars.atmospheric_params.sig0)
    torch.testing.assert_close(pd._data[:, 3], expected, rtol=0, atol=0)


@pytest.mark.parametrize("dimensional", [True, False], ids=["dim", "nondim"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_default_grid_matches_jax(setups, config, dimensional):
    """The default 100 x 100 grid, on the middle streamfunction and the
    lower-layer potential vorticity."""
    s = setups(config)
    for name, module in (("MiddleAtmosphericStreamfunctionDiagnostic",
                          "streamfunctions"),
                         ("LowerLayerAtmosphericPotentialVorticityDiagnostic",
                          "vorticity")):
        jd, pd = s.pair(module, name, {}, delta_x=None, delta_y=None)
        jd.dimensional = pd.dimensional = dimensional
        assert pd.grid_shape == jd.grid_shape == (100, 100)
        assert_matches(pd(s.t, s.traj), jd(s.t, s.traj))


@pytest.mark.parametrize("dimensional", [True, False], ids=["dim", "nondim"])
@pytest.mark.parametrize("heat_capacity", [None, 1.2e7],
                         ids=["flux", "heat_capacity"])
@pytest.mark.parametrize("cls", ["MiddleAtmosphericEddyHeatFluxDiagnostic",
                                 "MiddleAtmosphericEddyHeatFluxProfileDiagnostic"])
def test_eddy_flux_with_mean_states(setups, cls, heat_capacity, dimensional):
    """The eddy heat flux about the means of another trajectory (the mean
    states: a temperature and a V-wind diagnostic holding their own data),
    with and without ``heat_capacity``."""
    s = setups("maooam")
    other = np.ascontiguousarray(s.traj[:, ::-1] * 0.9)
    out = []
    for pkg, pars, kw in ((jax_eddy, s.jax_pars, {}),
                          (eddy, s.pars, {"device": "cpu"})):
        tmod = jax_temperatures if pkg is jax_eddy else temperatures
        wmod = jax_wind if pkg is jax_eddy else wind
        tm = tmod.MiddleAtmosphericTemperatureDiagnostic(pars, **GRID, **kw)
        vm = wmod.MiddleAtmosphericVWindDiagnostic(pars, **GRID, **kw)
        tm.set_data(s.t, other)
        vm.set_data(s.t, other)
        d = getattr(pkg, cls)(pars, **GRID, dimensional=dimensional,
                              temp_mean_state=tm, vwind_mean_state=vm,
                              heat_capacity=heat_capacity, **kw)
        out.append(d(s.t, s.traj))
        assert (d._plot_units == r" (in W m$^{-2}$)") == bool(heat_capacity)
    assert_matches(out[1], out[0])


@pytest.mark.parametrize("config", list(CONFIGS))
def test_field_point_matches_jax(setups, config):
    """``FieldPointDiagnostic`` at a point, then at another
    (``set_point_coordinates``), with the nearest host grid point; the
    series is a copy, so writing to it leaves the field's cache alone."""
    s = setups(config)
    out = []
    for pkg, pars, kw in ((jax_base, s.jax_pars, {}),
                          (base, s.pars, {"device": "cpu"})):
        mod = jax_streamfunctions if pkg is jax_base else streamfunctions
        field = mod.MiddleAtmosphericStreamfunctionDiagnostic(pars, **GRID,
                                                              **kw)
        fp = pkg.FieldPointDiagnostic(pars, 1.0, 1.0, field, **kw)
        s1 = fp(s.t, s.traj)
        s1 = s1.clone() if torch.is_tensor(s1) else s1.copy()
        assert fp.point_coordinates == (1.0, 1.0)
        fp.set_point_coordinates(2.0, 2.5)
        assert fp._diagnostic_data is None
        out.append((s1, fp.diagnostic, fp, field))
    (j1, j2, _, _), (p1, p2, fp, field) = out
    assert_matches(p1, j1)
    assert_matches(p2, j2)
    before = field.diagnostic.clone()
    fp.diagnostic.fill_(0.)
    assert torch.equal(field.diagnostic, before)


@pytest.mark.parametrize("dimensional", [True, False], ids=["dim", "nondim"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_variables_match_jax(setups, config, dimensional):
    """``VariablesDiagnostic`` on variables of every component, and
    ``GeopotentialHeightDifferenceDiagnostic`` between two couples of
    points (its point matrices on the device)."""
    s = setups(config)
    n = s.pars.ndim
    vr = s.pars.variables_range
    var_list = sorted({0, vr[0] - 1, vr[0], vr[1] - 1, n - 1})
    points = [((np.pi / 1.5, np.pi / 4), (np.pi / 1.5, 3 * np.pi / 4)),
              ((0.5, 1.0), (2.0, 2.5))]
    jv = jax_variables.VariablesDiagnostic(var_list, s.jax_pars, dimensional)
    pv = variables.VariablesDiagnostic(var_list, s.pars, dimensional,
                                       device="cpu")
    assert_matches(pv(s.t, s.traj), jv(s.t, s.traj))
    assert len(pv) == len(jv) == len(s.t)
    jg = jax_variables.GeopotentialHeightDifferenceDiagnostic(
        points, s.jax_pars, dimensional)
    pg = variables.GeopotentialHeightDifferenceDiagnostic(
        points, s.pars, dimensional, device="cpu")
    assert pg._func_points1.dtype == torch.float64
    assert_matches(pg(s.t, s.traj), jg(s.t, s.traj))
    assert pg._variable_labels == jg._variable_labels


def test_multi_and_list_match_jax(setups):
    """``MultiDiagnostic`` and ``FieldsDiagnosticsList`` hold and feed
    their diagnostics as the JAX package's do."""
    s = setups("maooam")
    outs = []
    for pkg, smod, tmod, pars, kw in (
            (jax_multi, jax_streamfunctions, jax_temperatures, s.jax_pars,
             {}),
            (multi, streamfunctions, temperatures, s.pars,
             {"device": "cpu"})):
        m = pkg.MultiDiagnostic(1, 2)
        m.add_diagnostic(smod.MiddleAtmosphericStreamfunctionDiagnostic(
            pars, **GRID, **kw))
        m.add_diagnostic(tmod.OceanicLayerTemperatureDiagnostic(
            pars, **GRID, **kw))
        fields = m(s.t, s.traj)
        fl = pkg.FieldsDiagnosticsList()
        fl.append_diagnostic(smod.MiddleAtmosphericStreamfunctionDiagnostic(
            pars, **GRID, **kw))
        fl.append_diagnostic(smod.OceanicLayerStreamfunctionDiagnostic(
            pars, **GRID, **kw))
        fl.set_data(s.t, s.traj, index=0)
        fl.set_data(s.t, s.traj[:, :5], index=1)
        outs.append((m, fields, fl, fl.diagnostics_list[1].diagnostic))
    (jm, jf, jl, jo), (pm, pf, pl, po) = outs
    assert (pm.nrows, pm.ncols, len(pm)) == (jm.nrows, jm.ncols, len(jm))
    assert pm.diagnostic_positions == jm.diagnostic_positions
    for got, ref in zip(pf, jf):
        assert_matches(got, ref)
    for got, ref in zip(pm.diagnostic, jm.diagnostic):
        assert_matches(got, ref)
    assert len(pl) == len(jl) == 5
    assert_matches(po, jo)


def test_inputs_of_every_kind(setups):
    """A NumPy array, a float64 CPU tensor, a float32 tensor (equal to the
    JAX package on the float64-promoted data) and the port's own
    ``get_trajectories()`` output give the same diagnostics, omega
    included."""
    s = setups("maooam")
    traj32 = s.traj.astype(np.float32)
    integ = RungeKuttaIntegrator()
    f, _ = create_tendencies(s.pars, device="cpu")
    integ.set_func(f)
    integ.integrate(0., 20., 0.1, ic=initial_state(s.pars), write_steps=10)
    t_port, traj_port = integ.get_trajectories()
    assert torch.is_tensor(traj_port) and traj_port.shape == s.traj.shape
    for entry in (("streamfunctions",
                   "MiddleAtmosphericStreamfunctionDiagnostic", {}),
                  ("wind", OMEGA, {}),
                  ("eddy", "MiddleAtmosphericEddyHeatFluxDiagnostic", {})):
        jd, pd = s.pair(*entry)
        jd.dimensional = pd.dimensional = True
        ref = jd(s.t, s.traj)
        assert_matches(pd(s.t, s.traj), ref)
        assert_matches(pd(torch.as_tensor(s.t), torch.as_tensor(s.traj)), ref)
        assert_matches(pd(s.t, torch.as_tensor(traj32)),
                       jd(s.t, traj32.astype(np.float64)))
        assert_matches(pd(t_port, traj_port),
                       jd(t_port, traj_port.numpy()))
        if entry[0] != "eddy":           # one record's eddy flux is 0
            # one record: a (ndim,) state
            assert_matches(pd(s.t[3], torch.as_tensor(s.traj[:, 3])),
                           jd(s.t[3], s.traj[:, 3]))


def test_plots_render_tensor_data(setups, tmp_path):
    """``plot`` (image and contour, with the orography), ``plot_grid_point``
    and ``movie`` render on Agg with tensor data, frames drawn through the
    animation's writer; so do the profile, variables and multi plots."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    s = setups("rp")
    t, traj = s.t[:3], torch.as_tensor(s.traj[:, :3])
    _, psi = s.pair("streamfunctions",
                    "MiddleAtmosphericStreamfunctionDiagnostic", {})
    psi.dimensional = True
    psi.set_data(t, traj)
    assert psi._orography is not None
    assert psi.plot(time_index=1) is not None
    assert psi.plot(time_index=2, style="contour") is not None
    assert len(psi.plot_grid_point(2, 3).lines[0].get_xdata()) == 3
    anim = psi.movie(output="animate")
    anim.save(tmp_path / "psi.gif", writer="pillow", fps=2)
    assert (tmp_path / "psi.gif").stat().st_size > 0
    _, prof = s.pair("eddy", "MiddleAtmosphericEddyHeatFluxProfileDiagnostic",
                     {})
    prof.set_data(t, traj)
    assert prof.plot(time_index=1) is not None
    prof.movie(output="animate").save(tmp_path / "prof.gif", writer="pillow",
                                      fps=2)
    vd = variables.VariablesDiagnostic([0, 1], s.pars, device="cpu")
    vd.set_data(t, traj)
    assert vd.plot() is not None
    vd.movie(output="animate").save(tmp_path / "vars.gif", writer="pillow",
                                    fps=2)
    m = multi.MultiDiagnostic(1, 2)
    m.add_diagnostic(psi)
    m.add_diagnostic(vd)
    fig, axes = m.plot(1)
    assert len(axes) == 2
    fl = multi.FieldsDiagnosticsList([psi, psi])
    assert fl.plot(time_index=0, style=["image", "contour"],
                   color_bar=False) is not None
    plt.close("all")


def test_movie_colour_range_ignores_nan():
    """The movie's colour range is ``np.nanmin``/``np.nanmax`` of the
    field, reduced on its device."""
    x = torch.tensor([[1., np.nan], [-3., 2.]])
    assert base.nan_extrema(x) == (-3., 2.)
    assert base.nan_extrema(x[:, :1] * 0 + 5.) == (5., 5.)
    lo, hi = base.nan_extrema(torch.full((2,), np.nan))
    assert np.isnan(lo) and np.isnan(hi)


def test_set_params_resets_the_cache_and_keeps_the_device(setups):
    s = setups("rp")
    d = streamfunctions.MiddleAtmosphericStreamfunctionDiagnostic(
        s.pars, **GRID, device="cpu")
    d(s.t, s.traj)
    d.set_params(s.pars)
    assert d._diagnostic_data is None
    d.set_params(s.pars, kwargs=dict(GRID, geopotential=True))
    assert d.device.type == "cpu" and d.geopotential
    assert d._diagnostic_data is None


def test_diagnostics_default_to_the_card(setups):
    """With no device, a diagnostic is built on ``cuda``; where there is no
    card, the call raises and does not land on the CPU."""
    pars = setups("rp").pars
    if torch.cuda.is_available():
        d = streamfunctions.MiddleAtmosphericStreamfunctionDiagnostic(pars)
        assert d.device.type == d._grid_basis.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            streamfunctions.MiddleAtmosphericStreamfunctionDiagnostic(pars)
        with pytest.raises((AssertionError, RuntimeError)):
            variables.VariablesDiagnostic([0], pars)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["maooam", "dynT"])
def test_card_matches_cpu(card, setups, config):
    """A trajectory tensor on the card gives a field tensor on the card,
    equal to the CPU's; omega included."""
    s = setups(config)
    traj = torch.as_tensor(s.traj, device="cuda")
    for module, name, kwargs in CATALOG[config]:
        _, cpu = s.pair(module, name, kwargs)
        cpu.dimensional = True
        ref = cpu(s.t, s.traj)
        gpu = getattr(MODULES[module][1], name)(s.pars, **GRID, **kwargs)
        got = gpu(s.t, traj)
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=RTOL,
                                   atol=RTOL * float(ref.abs().max()))
