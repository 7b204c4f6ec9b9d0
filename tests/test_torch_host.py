"""The port's own host layers (``qgs_tpu_torch.params``, ``.basis``,
``.inner_products``, ``.tensors``, ``.utils``) against the JAX package's,
from which they were copied: each configuration is set up by one shared
settings function applied to each package's ``QgParams``, and the tendency
tensors, their Jacobian tensors, ``ndim`` and the derived parameters the
tensor reads must be equal bit for bit.

The settings functions here are the ones the other ``test_torch_*`` files
build both packages' configurations from."""

import numpy as np
import pytest

from qgs_tpu.inner_products.analytic import (
    AtmosphericAnalyticInnerProducts as JaxAtmAnalytic,
    GroundAnalyticInnerProducts as JaxGroundAnalytic,
    OceanicAnalyticInnerProducts as JaxOceanAnalytic,
)
from qgs_tpu.inner_products.symbolic import (
    AtmosphericSymbolicInnerProducts as JaxAtmSymbolic,
    OceanicSymbolicInnerProducts as JaxOceanSymbolic,
)
from qgs_tpu.params.params import QgParams as JaxQgParams
from qgs_tpu.tensors import atmo_thermo as jax_atmo_thermo
from qgs_tpu.tensors import qgtensor as jax_qgtensor
from qgs_tpu_torch.inner_products import analytic as port_analytic
from qgs_tpu_torch.inner_products import symbolic as port_symbolic
from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.tensors import atmo_thermo as port_atmo_thermo
from qgs_tpu_torch.tensors import qgtensor as port_qgtensor
from qgs_tpu_torch.utils.sparse import COO


def maooam(QgParams):
    """MAOOAM, atmosphere 2x2 + ocean 2x4 (``qgs_maooam.py``, ndim 36)."""
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    pars.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3,
                                         'hlambda': 15.06})
    pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
    pars.atemperature_params.set_insolation(103.3333, 0)
    pars.gotemperature_params.set_insolation(310., 0)
    return pars


def rp(QgParams):
    """The atmosphere-only channel of ``qgs_rp.py`` (ndim 20), with its
    orography and thetas."""
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.2, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    return pars


def tlad(QgParams):
    """The qgs_rp orography system of ``tests/test_tlad.py:17-20`` and
    ``tests/test_lyapunov.py:187-190`` (ndim 20)."""
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.3})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.4, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    return pars


def ground(QgParams):
    """Atmosphere + ground with orography and heat exchange (the analytic
    configuration of ``tests/test_model_and_ground.py``, ndim 30)."""
    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8}, gtemperature_params=True)
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_ground_channel_fourier_modes()
    pars.ground_params.set_orography(0.2, 1)
    return pars


def symbolic(QgParams):
    """The symbolic-basis configuration of ``tests/test_symbolic_ip.py``
    (atmosphere 2x2 + ocean 2x4), whose inner products are computed by
    quadrature."""
    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8})
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
    pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
    pars.set_oceanic_basin_fourier_modes(2, 4, mode='symbolic')
    return pars


def _quartic(QgParams, **scheme):
    """The symbolic 2x2 + 2x4 configuration of ``tests/test_t4.py:20-23``
    and ``tests/test_symbolic_ip.py:71`` with a rank-5 radiation scheme
    (ndim 38: the 0-th order temperatures join the state)."""
    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8}, **scheme)
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
    pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
    pars.set_oceanic_basin_fourier_modes(2, 4, mode='symbolic')
    return pars


def t4(QgParams):
    """The full quartic T^4 scheme of ``tests/test_t4.py:18-27``."""
    return _quartic(QgParams, T4=True)


def dynamic_t(QgParams):
    """The dynamic-T scheme of ``tests/test_symbolic_ip.py:71``."""
    return _quartic(QgParams, dynamic_T=True)


def both_params(settings):
    """``(JAX package's QgParams, port's QgParams)`` from one settings
    function."""
    return settings(JaxQgParams), settings(QgParams)


def _inner_products(pars, atm, ocean, ground_ip, symbolic_ips):
    """The configuration's inner products, built as ``create_tendencies``
    of either package builds them (the symbolic ones by quadrature, as
    ``tests/test_symbolic_ip.py`` does)."""
    kw = dict(quadrature=True) if symbolic_ips else {}
    aip = atm(pars, **kw)
    oip = ocean(pars, **kw) if pars.oblocks is not None or symbolic_ips \
        else None
    gip = ground_ip(pars) if pars.gblocks is not None else None
    if oip is not None:
        aip.connect_to_ocean(oip)
    elif gip is not None:
        aip.connect_to_ground(gip)
    return aip, oip, gip


def _tensor(pars, atm, ocean, ground_ip, QgsTensor, symbolic_ips):
    """The configuration's tensor of class ``QgsTensor``."""
    return QgsTensor(pars, *_inner_products(pars, atm, ocean, ground_ip,
                                            symbolic_ips))


JAX_IPS = {False: (JaxAtmAnalytic, JaxOceanAnalytic, JaxGroundAnalytic),
           True: (JaxAtmSymbolic, JaxOceanSymbolic, None)}
PORT_IPS = {False: (port_analytic.AtmosphericAnalyticInnerProducts,
                    port_analytic.OceanicAnalyticInnerProducts,
                    port_analytic.GroundAnalyticInnerProducts),
            True: (port_symbolic.AtmosphericSymbolicInnerProducts,
                   port_symbolic.OceanicSymbolicInnerProducts, None)}

CONFIGS = {"maooam": (maooam, 36), "rp": (rp, 20), "tlad": (tlad, 20),
           "ground": (ground, 30), "symbolic": (symbolic, 36),
           "t4": (t4, 38), "dynT": (dynamic_t, 38)}
SYMBOLIC = ("symbolic", "t4", "dynT")
# each configuration's tensor class in both packages, and its rank
TENSORS = {"t4": ("QgsTensorT4", 5), "dynT": ("QgsTensorDynamicT", 5)}

# derived parameters the tensor reads (qgs_tpu/tensors/qgtensor.py)
DERIVED = ("ndim", "number_of_variables", "variables_range", "G", "Cpa",
           "Cpgo", "Lpa", "Lpgo", "LSBpa", "LSBpgo", "sbpa", "sbpgo",
           "T4LSBpa", "T4LSBpgo", "T4sbpa", "T4sbpgo", "dynamic_T",
           "atmospheric_params.kd", "atmospheric_params.kdp",
           "atmospheric_params.sig0", "atemperature_params.hd",
           "atemperature_params.thetas", "atemperature_params.sc",
           "oceanic_params.d", "oceanic_params.r", "ground_params.hk",
           "scale_params.beta")


def _value(pars, path):
    """A parameter as plain numbers (None where the configuration has no
    such component)."""
    obj = pars
    for name in path.split("."):
        if obj is None:
            return None
        obj = getattr(obj, name)
    if obj is None or isinstance(obj, (bool, int)):
        return obj
    try:
        return np.asarray(obj, dtype=np.float64)
    except (TypeError, ValueError):
        return np.asarray([None if v is None else float(v) for v in obj],
                          dtype=object)


@pytest.fixture(scope="module", params=list(CONFIGS))
def tensors(request):
    settings, ndim = CONFIGS[request.param]
    sym = request.param in SYMBOLIC
    cls, rank = TENSORS.get(request.param, ("QgsTensor", 3))
    jax_pars, port_pars = both_params(settings)
    t_jax = _tensor(jax_pars, *JAX_IPS[sym], getattr(jax_qgtensor, cls), sym)
    t_port = _tensor(port_pars, *PORT_IPS[sym], getattr(port_qgtensor, cls), sym)
    return ndim, rank, jax_pars, port_pars, t_jax, t_port


def test_tendency_tensor_equal_bit_for_bit(tensors):
    ndim, rank, _, _, t_jax, t_port = tensors
    for name in ("tensor", "jacobian_tensor"):
        a, b = getattr(t_jax, name), getattr(t_port, name)
        assert type(b) is COO
        assert tuple(b.shape) == tuple(a.shape) == (ndim + 1,) * rank
        assert b.nnz == a.nnz > 0
        assert np.array_equal(b.coords, a.coords)
        assert b.data.dtype == a.data.dtype
        assert np.array_equal(b.data, a.data)


def test_ndim_and_derived_parameters_equal(tensors):
    ndim, _, jax_pars, port_pars, _, _ = tensors
    assert port_pars.ndim == jax_pars.ndim == ndim
    for path in DERIVED:
        a, b = _value(jax_pars, path), _value(port_pars, path)
        if a is None or b is None:
            assert a is None and b is None, path
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), path


@pytest.mark.parametrize("config, cls", [
    ("maooam", "AtmoThermoTensor"), ("dynT", "AtmoThermoTensorDynamicT"),
    ("t4", "AtmoThermoTensorT4")])
def test_atmo_thermo_tensor_equal_bit_for_bit(config, cls):
    """The thermodynamic-only atmospheric tensors (rank 3 on MAOOAM, rank 5
    on the dynamic-T and T4 configurations) of the port's copy of
    ``tensors/atmo_thermo.py`` against the JAX package's."""
    settings, ndim = CONFIGS[config]
    sym = config in SYMBOLIC
    jax_pars, port_pars = both_params(settings)
    t_jax = getattr(jax_atmo_thermo, cls)(
        jax_pars, *_inner_products(jax_pars, *JAX_IPS[sym], sym))
    t_port = getattr(port_atmo_thermo, cls)(
        port_pars, *_inner_products(port_pars, *PORT_IPS[sym], sym))
    for name in ("tensor", "jacobian_tensor"):
        a, b = getattr(t_jax, name), getattr(t_port, name)
        assert type(b) is COO
        assert tuple(b.shape) == tuple(a.shape)
        assert len(b.shape) == (3 if config == "maooam" else 5)
        assert b.nnz == a.nnz > 0
        assert np.array_equal(b.coords, a.coords)
        assert np.array_equal(b.data, a.data)


def test_port_host_classes_are_its_own():
    """The port's host classes live in the port's modules."""
    classes = [QgParams, COO,
               *(c for ips in PORT_IPS.values() for c in ips if c),
               *(getattr(port_qgtensor, name) for name in (
                   "QgsTensor", "QgsTensorDynamicT", "QgsTensorT4")),
               *(getattr(port_atmo_thermo, name) for name in (
                   "AtmoThermoTensor", "AtmoThermoTensorDynamicT",
                   "AtmoThermoTensorT4"))]
    for cls in classes:
        assert cls.__module__.startswith("qgs_tpu_torch."), cls
