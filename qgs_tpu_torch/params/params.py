"""
Model configuration system
==========================

Typed, unit-aware configuration containers mirroring the reference feature
set (``qgs/params/params.py:193-2063``): seven parameter
containers aggregated in :class:`QgParams`, derived nondimensional
parameters as properties, spectral-mode bookkeeping, basis setters with
cross-component activation rules, and pickle persistence.

The convention throughout: a parameter set to ``None`` means the
corresponding physical process is *disabled*.
"""

from __future__ import annotations

import pickle
import warnings

import numpy as np
from sympy import Symbol, simplify

from qgs_tpu_torch.params.parameter import Parameter, ScalingParameter, ParametersArray
from qgs_tpu_torch.basis.fourier import (
    ChannelFourierBasis, BasinFourierBasis,
    contiguous_channel_basis, contiguous_basin_basis,
)


class Params:
    """Base class for a parameters container (dict-driven updates + pickling)."""

    _name = ""

    def __init__(self, dic=None):
        self.set_params(dic)

    def set_params(self, dic):
        """Assign values from ``dic`` to matching attributes, preserving each
        existing :class:`Parameter`'s units/flags when a bare float is given."""
        if dic is None:
            return
        for key, val in dic.items():
            if key in self.__dict__:
                cur = self.__dict__[key]
                if isinstance(cur, Parameter) and not isinstance(val, Parameter):
                    self.__dict__[key] = Parameter(
                        val, input_dimensional=cur.input_dimensional, units=cur.units,
                        description=cur.description, scale_object=cur._scale_object,
                        symbol=cur.symbol, return_dimensional=cur.return_dimensional)
                elif isinstance(cur, ScalingParameter) and not isinstance(val, ScalingParameter):
                    self.__dict__[key] = ScalingParameter(
                        val, units=cur.units, description=cur.description,
                        symbol=cur.symbol, dimensional=cur.dimensional)
                else:
                    self.__dict__[key] = val

    # -- persistence -------------------------------------------------------
    def save_to_file(self, filename, **kwargs):
        with open(filename, "wb") as f:
            pickle.dump(self.__dict__, f, **kwargs)

    def load_from_file(self, filename, **kwargs):
        with open(filename, "rb") as f:
            tmp = pickle.load(f, **kwargs)
        self.__dict__.clear()
        self.__dict__.update(tmp)

    # -- display -----------------------------------------------------------
    def __str__(self):
        s = ""
        for key, val in self.__dict__.items():
            if "params" in key or key.startswith("_") or val is None:
                continue
            if isinstance(val, Parameter):
                if val.input_dimensional:
                    s += f"'{key}': {val.dimensional_value}  {val.units}  ({val.description}),\n"
                else:
                    u = "" if val.nondimensional_value == val.dimensional_value else "[nondim]"
                    s += f"'{key}': {val.nondimensional_value}  {u}  ({val.description}),\n"
            elif isinstance(val, ScalingParameter):
                u = val.units if val.dimensional else "[nondim]"
                s += f"'{key}': {float(val)}  {u}  ({val.description}),\n"
            elif isinstance(val, (np.ndarray, list, tuple)) and len(val) and isinstance(val[0], Parameter):
                for i, v in enumerate(val):
                    ev = v.dimensional_value if v.input_dimensional else v.nondimensional_value
                    s += f"'{key}[{i + 1}]': {ev}  ({v.description}),\n"
            else:
                s += f"'{key}': {val},\n"
        return s

    def _list_params(self):
        return self._name + " Parameters:\n" + self.__str__()

    def print_params(self):
        print(self._list_params())


# ---------------------------------------------------------------------------
# Scale parameters
# ---------------------------------------------------------------------------

class ScaleParams(Params):
    """Model scales: characteristic length, Coriolis parameter, aspect ratio,
    Earth radius, reference latitude, layer pressure difference
    (ref ``params.py:193-273``)."""

    _name = "Scale"

    def __init__(self, dic=None):
        Params.__init__(self, dic)
        self.scale = ScalingParameter(5.e6, units='[m]', description="characteristic space scale (L*pi)",
                                      dimensional=True)
        self.f0 = ScalingParameter(1.032e-4, units='[s^-1]',
                                   description="Coriolis parameter at the middle of the domain",
                                   dimensional=True, symbol=Symbol('f0'))
        self.n = ScalingParameter(1.3e0, dimensional=False, description="aspect ratio (n = 2 L_y / L_x)",
                                  symbol=Symbol('n', positive=True))
        self.rra = ScalingParameter(6370.e3, units='[m]', description="earth radius", dimensional=True)
        self.phi0_npi = ScalingParameter(0.25e0, dimensional=False,
                                         description="latitude expressed in fraction of pi")
        self.deltap = ScalingParameter(5.e4, units='[Pa]',
                                       description="pressure difference between the two atmospheric layers",
                                       dimensional=True)
        self.Ha = ScalingParameter(8500., units='[m]',
                                   description="average height of the 500 hPa pressure level at midlatitude",
                                   dimensional=True, symbol=Symbol('H_a'))
        self.set_params(dic)

    @property
    def L(self):
        """Typical length scale L = scale / pi [m]."""
        return ScalingParameter(self.scale / np.pi, units=self.scale.units,
                                description="typical length scale L", symbol=Symbol('L'),
                                dimensional=True)

    @property
    def L_y(self):
        return ScalingParameter(float(self.scale), units=self.scale.units,
                                description="meridional extent of the domain", dimensional=True)

    @property
    def L_x(self):
        return ScalingParameter(2 * float(self.scale) / float(self.n), units=self.scale.units,
                                description="zonal extent of the domain", dimensional=True)

    @property
    def phi0(self):
        return ScalingParameter(float(self.phi0_npi) * np.pi, units='[rad]',
                                description="reference latitude", dimensional=True,
                                symbol=Symbol('phi0'))

    @property
    def beta(self):
        """Nondimensional meridional gradient of the Coriolis parameter at phi0."""
        return Parameter(float(self.L) / float(self.rra) * np.cos(float(self.phi0)) / np.sin(float(self.phi0)),
                         input_dimensional=False, units='[m^-1][s^-1]', scale_object=self,
                         description="meridional gradient of the Coriolis parameter at phi0",
                         symbol=Symbol('beta'))


# ---------------------------------------------------------------------------
# Component parameter containers
# ---------------------------------------------------------------------------

class AtmosphericParams(Params):
    """Atmospheric dynamical parameters (ref ``params.py:276-318``)."""

    _name = "Atmospheric"

    def __init__(self, scale_params, dic=None):
        Params.__init__(self, dic)
        self._scale_params = scale_params
        self.kd = Parameter(0.1, input_dimensional=False, scale_object=scale_params, units='[s^-1]',
                            description="atmosphere bottom friction coefficient", symbol=Symbol('k_d'))
        self.kdp = Parameter(0.01, input_dimensional=False, scale_object=scale_params, units='[s^-1]',
                             description="atmosphere internal friction coefficient", symbol=Symbol('k_p'))
        self.sigma = Parameter(0.2e0, input_dimensional=False, scale_object=scale_params,
                               units='[m^2][s^-2][Pa^-2]',
                               description="static stability of the atmosphere", symbol=Symbol('sigma'))
        self.set_params(dic)

    @property
    def sig0(self):
        """Half the static stability."""
        return Parameter(self.sigma / 2, input_dimensional=False, scale_object=self._scale_params,
                         units='[m^2][s^-2][Pa^-2]', description="0.5 * static stability",
                         symbol=self.sigma.symbol / 2)


class AtmosphericTemperatureParams(Params):
    """Atmospheric temperature / heat-exchange parameters (ref ``params.py:321-469``)."""

    _name = "Atmospheric Temperature"

    def __init__(self, scale_params, dic=None):
        Params.__init__(self, dic)
        self._scale_params = scale_params
        self.hd = Parameter(0.045, input_dimensional=False, units='[s]', scale_object=scale_params,
                            description="Newtonian cooling coefficient", symbol=Symbol('hd'))
        self.thetas = None
        self.gamma = None
        self.C = None
        self.eps = None
        self.T0 = None
        self.sc = None
        self.hlambda = None
        self.dynamic_T = None
        self.set_params(dic)

    def set_insolation(self, value, pos=None, dynamic_T=False):
        """Set the spectral decomposition of the atmospheric short-wave radiation C_a."""
        if isinstance(value, (float, int)) and pos is not None and self.C is not None:
            offset = 0 if (self.dynamic_T or dynamic_T) else 1
            self.C[pos] = Parameter(value, units='[W][m^-2]', scale_object=self._scale_params,
                                    description=f"spectral component {pos + offset} of the short-wave "
                                                f"radiation of the atmosphere",
                                    return_dimensional=True, symbol=Symbol('C_a' + str(pos + offset)))
        elif hasattr(value, "__iter__") or isinstance(value, int):
            self._create_insolation(value, dynamic_T)
        else:
            warnings.warn("scalar insolation value provided without `pos`: unchanged")

    def _create_insolation(self, values, dynamic_T=False):
        if hasattr(values, "__iter__"):
            values = list(values)
        else:
            values = values * [0.0]
        dim = len(values)
        offset = 1
        if dynamic_T:
            offset = 0
            self.dynamic_T = True
        d = [f"spectral component {p + offset} of the short-wave radiation of the atmosphere"
             for p in range(dim)]
        sy = [Symbol('C_a' + str(p + offset)) for p in range(dim)]
        self.C = ParametersArray(values, units='[W][m^-2]', scale_object=self._scale_params,
                                 description=d, return_dimensional=True, symbols=sy)

    def set_thetas(self, value, pos=None):
        """Set the spectral decomposition of the Newtonian-cooling equilibrium profile."""
        if isinstance(value, (float, int)) and pos is not None and self.thetas is not None:
            self.thetas[pos] = Parameter(value, scale_object=self._scale_params,
                                         description=f"spectral component {pos + 1} of the temperature profile",
                                         return_dimensional=False, input_dimensional=False,
                                         symbol=Symbol('thetas_' + str(pos + 1)))
        elif hasattr(value, "__iter__"):
            values = list(value)
            d = [f"spectral component {p + 1} of the temperature profile" for p in range(len(values))]
            sy = [Symbol('thetas_' + str(p + 1)) for p in range(len(values))]
            self.thetas = ParametersArray(values, scale_object=self._scale_params, description=d,
                                          return_dimensional=False, input_dimensional=False, symbols=sy)
        else:
            warnings.warn("scalar thetas value provided without `pos`: unchanged")


class OceanicParams(Params):
    """Oceanic dynamical parameters (ref ``params.py:472-510``)."""

    _name = "Oceanic"

    def __init__(self, scale_params, dic=None):
        Params.__init__(self, dic)
        self._scale_params = scale_params
        self.gp = Parameter(3.1e-2, units='[m][s^-2]', return_dimensional=True, scale_object=scale_params,
                            description="reduced gravity", symbol=Symbol('g_p'))
        self.r = Parameter(1.e-8, units='[s^-1]', scale_object=scale_params,
                           description="frictional coefficient at the bottom of the ocean",
                           symbol=Symbol('r'))
        self.h = Parameter(5.e2, units='[m]', return_dimensional=True, scale_object=scale_params,
                           description="depth of the water layer of the ocean", symbol=Symbol('h'))
        self.d = Parameter(1.e-8, units='[s^-1]', scale_object=scale_params,
                           description="strength of the ocean-atmosphere mechanical coupling",
                           symbol=Symbol('d'))
        self.set_params(dic)


class _GoTemperatureParams(Params):
    """Shared implementation for oceanic / ground temperature containers."""

    _symbol_prefix = 'C_go'
    _component = "ocean"

    def __init__(self, scale_params, dic=None, gamma_default=2.e8, gamma_symbol='gamma_o',
                 gamma_descr='specific heat capacity of the ocean'):
        Params.__init__(self, dic)
        self._scale_params = scale_params
        self.gamma = Parameter(gamma_default, units='[J][m^-2][K^-1]', scale_object=scale_params,
                               return_dimensional=True, description=gamma_descr,
                               symbol=Symbol(gamma_symbol))
        self.C = None
        self.T0 = None
        self.dynamic_T = None
        self.set_params(dic)

    def set_insolation(self, value, pos=None, dynamic_T=False):
        """Set the spectral decomposition of the ground/ocean short-wave radiation."""
        if isinstance(value, (float, int)) and pos is not None and self.C is not None:
            offset = 0 if (self.dynamic_T or dynamic_T) else 1
            self.C[pos] = Parameter(value, units='[W][m^-2]', scale_object=self._scale_params,
                                    description=f"spectral component {pos + offset} of the short-wave "
                                                f"radiation of the {self._component}",
                                    return_dimensional=True,
                                    symbol=Symbol(self._symbol_prefix + str(pos + offset)))
        elif hasattr(value, "__iter__") or isinstance(value, int):
            self._create_insolation(value, dynamic_T)
        else:
            warnings.warn("scalar insolation value provided without `pos`: unchanged")

    def _create_insolation(self, values, dynamic_T=False):
        if hasattr(values, "__iter__"):
            values = list(values)
        else:
            values = values * [0.0]
        dim = len(values)
        offset = 1
        if dynamic_T:
            offset = 0
            self.dynamic_T = True
        d = [f"spectral component {p + offset} of the short-wave radiation of the {self._component}"
             for p in range(dim)]
        sy = [Symbol(self._symbol_prefix + str(p + offset)) for p in range(dim)]
        self.C = ParametersArray(values, units='[W][m^-2]', scale_object=self._scale_params,
                                 description=d, return_dimensional=True, symbols=sy)


class OceanicTemperatureParams(_GoTemperatureParams):
    """Oceanic temperature parameters (ref ``params.py:513-599``)."""

    _name = "Oceanic Temperature"
    _component = "ocean"

    def __init__(self, scale_params, dic=None):
        _GoTemperatureParams.__init__(self, scale_params, dic, gamma_default=2.e8,
                                      gamma_symbol='gamma_o',
                                      gamma_descr='specific heat capacity of the ocean')


class GroundTemperatureParams(_GoTemperatureParams):
    """Ground temperature parameters (ref ``params.py:683-771``)."""

    _name = "Ground Temperature"
    _component = "ground"

    def __init__(self, scale_params, dic=None):
        _GoTemperatureParams.__init__(self, scale_params, dic, gamma_default=2.e8,
                                      gamma_symbol='gamma_g',
                                      gamma_descr='specific heat capacity of the ground')


class GroundParams(Params):
    """Ground (orography) parameters (ref ``params.py:602-680``)."""

    _name = "Ground"

    def __init__(self, scale_params, dic=None):
        Params.__init__(self, dic)
        self._scale_params = scale_params
        self.hk = None
        self.orographic_basis = "atmospheric"
        self.set_params(dic)

    def set_orography(self, value, pos=None, basis="atmospheric"):
        """Set the spectral decomposition of the orography profile h_k."""
        self.orographic_basis = basis
        if isinstance(value, (float, int)) and pos is not None and self.hk is not None:
            self.hk[pos] = Parameter(value, scale_object=self._scale_params,
                                     description=f"spectral component {pos + 1} of the orography",
                                     return_dimensional=False, input_dimensional=False,
                                     symbol=Symbol('hk_' + str(pos + 1)))
        elif hasattr(value, "__iter__"):
            values = list(value)
            d = [f"spectral component {p + 1} of the orography" for p in range(len(values))]
            sy = [Symbol('hk_' + str(p + 1)) for p in range(len(values))]
            self.hk = ParametersArray(values, scale_object=self._scale_params, description=d,
                                      return_dimensional=False, input_dimensional=False, symbols=sy)
        else:
            warnings.warn("scalar orography value provided without `pos`: unchanged")


# ---------------------------------------------------------------------------
# The aggregated configuration
# ---------------------------------------------------------------------------

class QgParams(Params):
    """Global model configuration (ref ``params.py:774-2063``).

    Aggregates the scale/component containers, owns the spectral bases, and
    derives every nondimensional parameter used by the tendency tensor.
    """

    _name = "General"

    def __init__(self, dic=None, scale_params=None,
                 atmospheric_params=True, atemperature_params=True,
                 oceanic_params=None, otemperature_params=None,
                 ground_params=True, gtemperature_params=None,
                 dynamic_T=False, T4=False):

        Params.__init__(self, dic)

        self.scale_params = scale_params if scale_params is not None else ScaleParams(dic)

        self.atmospheric_params = (AtmosphericParams(self.scale_params, dic=dic)
                                   if atmospheric_params is True else atmospheric_params)
        self.atemperature_params = (AtmosphericTemperatureParams(self.scale_params, dic=dic)
                                    if atmospheric_params is True else atemperature_params)
        self.oceanic_params = (OceanicParams(self.scale_params, dic)
                               if oceanic_params is True else oceanic_params)
        self.ground_params = (GroundParams(self.scale_params, dic)
                              if ground_params is True else ground_params)
        if otemperature_params is True:
            self.gotemperature_params = OceanicTemperatureParams(self.scale_params, dic)
        else:
            self.gotemperature_params = otemperature_params
        if gtemperature_params is True:
            self.gotemperature_params = GroundTemperatureParams(self.scale_params, dic)
        elif gtemperature_params is not None:
            self.gotemperature_params = gtemperature_params

        self._atmospheric_basis = None
        self._oceanic_basis = None
        self._ground_basis = None
        self._number_of_atmospheric_modes = 0
        self._number_of_oceanic_modes = 0
        self._number_of_ground_modes = 0
        self._ams = None
        self._oms = None
        self._gms = None

        self.dynamic_T = dynamic_T
        self.T4 = T4
        if T4:
            self.dynamic_T = True

        self._atmospheric_var_string = []
        self._oceanic_var_string = []
        self._ground_var_string = []
        self._atmospheric_latex_var_string = []
        self._oceanic_latex_var_string = []
        self._ground_latex_var_string = []
        self._components_units = [r'm$^2$s$^{-1}$', r'K', r'm$^2$s$^{-1}$', r'K']
        self.time_unit = 'days'

        # physical constants
        self.rr = Parameter(287.058e0, return_dimensional=True, units='[J][kg^-1][K^-1]',
                            scale_object=self.scale_params, description="gas constant of dry air",
                            symbol=Symbol('R'))
        self.sb = Parameter(5.67e-8, return_dimensional=True, units='[J][m^-2][s^-1][K^-4]',
                            scale_object=self.scale_params, description="Stefan-Boltzmann constant",
                            symbol=Symbol('sigma_b'))

        self.set_params(dic)

    # -- derived nondimensional parameters (ref ``params.py:946-1129``) ----

    @property
    def LR(self):
        """Reduced Rossby deformation radius sqrt(g' h)/f0 [m]."""
        op, scp = self.oceanic_params, self.scale_params
        if op is None:
            return None
        try:
            return (op.gp * op.h) ** 0.5 / scp.f0
        except Exception:
            return None

    @property
    def G(self):
        """The G = -L^2/LR^2 parameter."""
        if self.LR is None:
            return None
        try:
            return -self.scale_params.L ** 2 / self.LR ** 2
        except Exception:
            return None

    @property
    def Cpgo(self):
        """C'_go,i = R C_go,i / (gamma_go L^2 f0^3)."""
        gotp, scp = self.gotemperature_params, self.scale_params
        if gotp is None:
            return None
        try:
            return gotp.C / (gotp.gamma * scp.f0) * self.rr / (scp.f0 ** 2 * scp.L ** 2)
        except Exception:
            return None

    @property
    def Lpgo(self):
        """lambda'_go = lambda / (gamma_go f0)."""
        atp, gotp, scp = self.atemperature_params, self.gotemperature_params, self.scale_params
        if atp is None or gotp is None:
            return None
        try:
            return atp.hlambda / (gotp.gamma * scp.f0)
        except Exception:
            return None

    @property
    def Cpa(self):
        """C'_a,i = R C_a,i / (2 gamma_a L^2 f0^3)."""
        atp, scp = self.atemperature_params, self.scale_params
        if atp is None:
            return None
        try:
            return atp.C / (atp.gamma * scp.f0) * self.rr / (scp.f0 ** 2 * scp.L ** 2) / 2
        except Exception:
            return None

    @property
    def Lpa(self):
        """lambda'_a = lambda / (gamma_a f0)."""
        atp, scp = self.atemperature_params, self.scale_params
        if atp is None:
            return None
        try:
            return atp.hlambda / (atp.gamma * scp.f0)
        except Exception:
            return None

    @property
    def sbpgo(self):
        """Linearized long-wave radiation lost by ground/ocean: 4 sb T_go0^3/(gamma_go f0)."""
        gotp, scp = self.gotemperature_params, self.scale_params
        if gotp is None or self.dynamic_T:
            return None
        try:
            return 4 * self.sb * gotp.T0 ** 3 / (gotp.gamma * scp.f0)
        except Exception:
            return None

    @property
    def sbpa(self):
        """Linearized long-wave radiation from atmosphere absorbed by ground/ocean."""
        atp, gotp, scp = self.atemperature_params, self.gotemperature_params, self.scale_params
        if gotp is None or atp is None or self.dynamic_T:
            return None
        try:
            return 8 * atp.eps * self.sb * atp.T0 ** 3 / (gotp.gamma * scp.f0)
        except Exception:
            return None

    @property
    def LSBpgo(self):
        """Linearized long-wave radiation from ground/ocean absorbed by atmosphere."""
        atp, gotp, scp = self.atemperature_params, self.gotemperature_params, self.scale_params
        if atp is None or gotp is None or self.dynamic_T:
            return None
        try:
            return 2 * atp.eps * self.sb * gotp.T0 ** 3 / (atp.gamma * scp.f0)
        except Exception:
            return None

    @property
    def LSBpa(self):
        """Linearized long-wave radiation lost by atmosphere to space & ground/ocean."""
        atp, scp = self.atemperature_params, self.scale_params
        if atp is None or self.dynamic_T:
            return None
        try:
            return 8 * atp.eps * self.sb * atp.T0 ** 3 / (atp.gamma * scp.f0)
        except Exception:
            return None

    @property
    def T4sbpgo(self):
        """T^4 scheme: sb L^6 f0^5 / (gamma_go R^3)."""
        gotp, scp = self.gotemperature_params, self.scale_params
        if gotp is None:
            return None
        try:
            return self.sb * scp.L ** 6 * scp.f0 ** 5 / (gotp.gamma * self.rr ** 3)
        except Exception:
            return None

    @property
    def T4sbpa(self):
        """T^4 scheme: 16 eps sb L^6 f0^5 / (gamma_go R^3)."""
        atp, gotp, scp = self.atemperature_params, self.gotemperature_params, self.scale_params
        if gotp is None or atp is None:
            return None
        try:
            return 16 * atp.eps * self.sb * scp.L ** 6 * scp.f0 ** 5 / (gotp.gamma * self.rr ** 3)
        except Exception:
            return None

    @property
    def T4LSBpgo(self):
        """T^4 scheme: eps sb L^6 f0^5 / (2 gamma_a R^3)."""
        atp, scp = self.atemperature_params, self.scale_params
        if atp is None:
            return None
        try:
            return 0.5 * atp.eps * self.sb * scp.L ** 6 * scp.f0 ** 5 / (atp.gamma * self.rr ** 3)
        except Exception:
            return None

    @property
    def T4LSBpa(self):
        """T^4 scheme: 16 eps sb L^6 f0^5 / (gamma_a R^3)."""
        atp, scp = self.atemperature_params, self.scale_params
        if atp is None:
            return None
        try:
            return 16 * atp.eps * self.sb * scp.L ** 6 * scp.f0 ** 5 / (atp.gamma * self.rr ** 3)
        except Exception:
            return None

    # -- field scalings ----------------------------------------------------
    @property
    def streamfunction_scaling(self):
        return self.scale_params.L ** 2 * self.scale_params.f0

    @property
    def temperature_scaling(self):
        return self.streamfunction_scaling * self.scale_params.f0 / self.rr

    @property
    def geopotential_scaling(self):
        return self.scale_params.f0 / 9.81

    @property
    def dimensional_time(self):
        """Conversion factor nondimensional time -> :attr:`time_unit`."""
        c = {'hours': 3600, 'days': 24 * 3600, 'years': 24 * 3600 * 365}.get(self.time_unit, 24 * 3600)
        return 1 / (float(self.scale_params.f0) * c)

    # -- variables bookkeeping (ref ``params.py:1229-1282``) ---------------

    @property
    def ndim(self):
        """Total number of model variables."""
        return self.variables_range[-1]

    @property
    def nmod(self):
        """[number of atmospheric modes, number of ocean-or-ground modes]."""
        if self._number_of_oceanic_modes != 0:
            return [self._number_of_atmospheric_modes, self._number_of_oceanic_modes]
        return [self._number_of_atmospheric_modes, self._number_of_ground_modes]

    @property
    def variables_range(self):
        """Upper bound of variable indices per component
        [psi_a | theta_a (+T_a0) | psi_o | deltaT_o (+T_o0)] or
        [psi_a | theta_a (+T_a0) | deltaT_g (+T_g0)]."""
        natm, ngoc = self.nmod
        vr = [natm, 2 * natm]
        if self.dynamic_T:
            vr[-1] += 1
        if ngoc > 0:
            vr.append(vr[-1] + ngoc)
            if self._oceanic_basis is not None:
                vr.append(vr[-1] + ngoc)
            if self.dynamic_T:
                vr[-1] += 1
        return vr

    @property
    def number_of_variables(self):
        vr = self.variables_range
        return [vr[0]] + [vr[i] - vr[i - 1] for i in range(1, len(vr))]

    @property
    def var_string(self):
        return list(self._atmospheric_var_string + self._oceanic_var_string + self._ground_var_string)

    @property
    def latex_var_string(self):
        return ['{' + v + '}' for v in (self._atmospheric_latex_var_string
                                        + self._oceanic_latex_var_string
                                        + self._ground_latex_var_string)]

    @property
    def latex_components_units(self):
        return self._components_units

    def get_variable_units(self, i):
        if i >= self.ndim:
            warnings.warn(f"variable {i} doesn't exist")
            return None
        vr = self.variables_range
        if i < vr[0]:
            return self._components_units[0]
        if vr[0] <= i < vr[1]:
            return self._components_units[1]
        if self.oceanic_basis is not None:
            if vr[1] <= i < vr[2]:
                return self._components_units[2]
            if vr[2] <= i < vr[3]:
                return self._components_units[3]
        if self.ground_basis is not None and vr[1] <= i < vr[2]:
            return self._components_units[3]

    # -- dict-driven updates cascading into sub-containers -----------------

    def set_params(self, dic):
        if dic is None:
            return
        Params.set_params(self, dic)
        for attr in ("scale_params", "atmospheric_params", "atemperature_params",
                     "oceanic_params", "ground_params", "gotemperature_params"):
            sub = self.__dict__.get(attr)
            if sub is not None:
                sub.set_params(dic)

    def print_params(self):
        s = self._list_params() + "\n"
        for attr in ("scale_params", "atmospheric_params", "atemperature_params",
                     "oceanic_params", "ground_params", "gotemperature_params"):
            sub = self.__dict__.get(attr)
            if sub is not None:
                s += sub._list_params() + "\n"
        print("qgs-tpu parameters summary")
        print("==========================\n")
        print(s)

    # -- symbolic-basis setters (ref ``params.py:1378-1530``) --------------

    @property
    def atmospheric_basis(self):
        return self._atmospheric_basis

    @atmospheric_basis.setter
    def atmospheric_basis(self, basis):
        self._ams = self._oms = self._gms = None
        self._atmospheric_basis = basis
        self._number_of_atmospheric_modes = len(basis.functions)
        if self.dynamic_T:
            self._atmospheric_basis.functions.insert(0, simplify("1"))
        if self.ground_params is not None and self.ground_params.orographic_basis == "atmospheric":
            self.ground_params.set_orography(self._number_of_atmospheric_modes * [0.e0])
        if self.atemperature_params is not None:
            self.atemperature_params.set_thetas(self._number_of_atmospheric_modes * [0.e0])

    @property
    def oceanic_basis(self):
        return self._oceanic_basis

    @oceanic_basis.setter
    def oceanic_basis(self, basis):
        self._ams = self._oms = self._gms = None
        self._oceanic_basis = basis
        self._number_of_ground_modes = 0
        self._number_of_oceanic_modes = len(basis)
        if self.dynamic_T:
            self._oceanic_basis.functions.insert(0, simplify("1"))
        self._activate_heat_exchange()
        if self.gotemperature_params is not None:
            self._set_go_insolation()
            if self.ground_params is not None:
                self.ground_params.hk = None  # ocean disables orography

    @property
    def ground_basis(self):
        return self._ground_basis

    @ground_basis.setter
    def ground_basis(self, basis):
        self._ams = self._oms = self._gms = None
        if len(basis) and (basis[0] == 1 or basis[0] == Symbol("1")):
            del basis[0]
        self._ground_basis = basis
        self._number_of_ground_modes = len(basis)
        self._number_of_oceanic_modes = 0
        if self.dynamic_T:
            self._ground_basis.functions.insert(0, simplify("1"))
        self._activate_heat_exchange()
        if self.gotemperature_params is not None:
            if self.ground_params is not None and self.ground_params.hk is None:
                if self.ground_params.orographic_basis == 'atmospheric':
                    self.ground_params.set_orography(self._number_of_atmospheric_modes * [0.e0])
                else:
                    self.ground_params.set_orography(self._number_of_ground_modes * [0.e0])
                self.ground_params.set_orography(0.1, 1)
            self._set_go_insolation()

    def _activate_heat_exchange(self):
        """Disable Newtonian cooling and enable the heat-exchange scheme with
        default values when a ground/ocean component is activated."""
        atp = self.atemperature_params
        if atp is None:
            return
        atp.thetas = None
        atp.hd = None
        atp.gamma = Parameter(1.e7, units='[J][m^-2][K^-1]', scale_object=self.scale_params,
                              description='specific heat capacity of the atmosphere',
                              return_dimensional=True, symbol=Symbol('gamma_a'))
        if self.dynamic_T:
            atp.set_insolation((self.nmod[0] + 1) * [0.e0], None, True)
            atp.set_insolation(100.0, 0, True)
            atp.set_insolation(100.0, 1, True)
        else:
            atp.set_insolation(self.nmod[0] * [0.e0])
            atp.set_insolation(100.0, 0)
            atp.T0 = Parameter(270.0, units='[K]', scale_object=self.scale_params,
                               return_dimensional=True,
                               description="stationary solution for the 0-th order atmospheric temperature",
                               symbol=Symbol('T_a0'))
        atp.eps = Parameter(0.76e0, input_dimensional=False,
                            description="emissivity coefficient for the grey-body atmosphere",
                            symbol=Symbol('epsilon'))
        atp.sc = Parameter(1., input_dimensional=False,
                           description="ratio of surface to atmosphere temperature",
                           symbol=Symbol('sc'))
        atp.hlambda = Parameter(20.00, units='[W][m^-2][K^-1]', scale_object=self.scale_params,
                                return_dimensional=True,
                                description="sensible+turbulent heat exchange between "
                                            "ocean/ground and atmosphere",
                                symbol=Symbol('lambda'))

    def _set_go_insolation(self):
        gotp = self.gotemperature_params
        if self.dynamic_T:
            gotp.set_insolation((self.nmod[0] + 1) * [0.e0], None, True)
            gotp.set_insolation(350.0, 0, True)
            gotp.set_insolation(350.0, 1, True)
        else:
            gotp.set_insolation(self.nmod[0] * [0.e0])
            gotp.set_insolation(350.0, 0)
            gotp.T0 = Parameter(285.0, units='[K]', scale_object=self.scale_params,
                                return_dimensional=True,
                                description="stationary solution for the 0-th order oceanic temperature",
                                symbol=Symbol('T_go0'))

    # -- mode setters ------------------------------------------------------

    def set_atmospheric_modes(self, basis, auto=False):
        """Configure the atmospheric modes from a symbolic basis object."""
        if auto:
            if self.atemperature_params is None:
                self.atemperature_params = AtmosphericTemperatureParams(self.scale_params)
            if self.atmospheric_params is None:
                self.atmospheric_params = AtmosphericParams(self.scale_params)
        self.atmospheric_basis = basis
        self._atmospheric_var_string = []
        self._atmospheric_latex_var_string = []
        for i in range(1, self.nmod[0] + 1):
            self._atmospheric_latex_var_string.append(r'psi_{{\rm a},' + str(i) + "}")
            self._atmospheric_var_string.append('psi_a_' + str(i))
        if self.dynamic_T:
            self._atmospheric_latex_var_string.append(r', T_{{\rm a},0}')
            self._atmospheric_var_string.append('T_a_0')
        for i in range(1, self.nmod[0] + 1):
            self._atmospheric_latex_var_string.append(r'theta_{{\rm a},' + str(i) + "}")
            self._atmospheric_var_string.append('theta_a_' + str(i))

    def set_oceanic_modes(self, basis, auto=True):
        """Configure the oceanic modes from a symbolic basis object."""
        if self._atmospheric_basis is None:
            print('Atmosphere modes not set up. Add an atmosphere before adding an ocean!')
            return
        if auto:
            if self.gotemperature_params is None or isinstance(self.gotemperature_params,
                                                               GroundTemperatureParams):
                self.gotemperature_params = OceanicTemperatureParams(self.scale_params)
            if self.oceanic_params is None:
                self.oceanic_params = OceanicParams(self.scale_params)
            self.ground_params = None
            self._ground_basis = None
        self.oceanic_basis = basis
        self._oceanic_var_string = []
        self._oceanic_latex_var_string = []
        self._ground_var_string = []
        self._ground_latex_var_string = []
        for i in range(1, self.nmod[1] + 1):
            self._oceanic_latex_var_string.append(r'psi_{\rm o,' + str(i) + "}")
            self._oceanic_var_string.append('psi_o_' + str(i))
        if self.dynamic_T:
            self._oceanic_latex_var_string.append(r', T_{{\rm o},0}')
            self._oceanic_var_string.append('T_o_0')
        for i in range(1, self.nmod[1] + 1):
            self._oceanic_latex_var_string.append(r'delta T_{{\rm o},' + str(i) + "}")
            self._oceanic_var_string.append('delta_T_o_' + str(i))

    def set_ground_modes(self, basis=None, auto=True):
        """Configure the ground modes from a symbolic basis object (or reuse the
        atmospheric basis)."""
        if self._atmospheric_basis is None:
            print('Atmosphere modes not set up. Add an atmosphere before adding the ground!')
            return
        if auto:
            if self.gotemperature_params is None or isinstance(self.gotemperature_params,
                                                               OceanicTemperatureParams):
                self.gotemperature_params = GroundTemperatureParams(self.scale_params)
            if self.ground_params is None:
                self.ground_params = GroundParams(self.scale_params)
            self.oceanic_params = None
            self._oceanic_basis = None
        self.ground_basis = basis if basis is not None else self._atmospheric_basis
        self._oceanic_var_string = []
        self._oceanic_latex_var_string = []
        self._ground_var_string = []
        self._ground_latex_var_string = []
        if self.dynamic_T:
            self._oceanic_latex_var_string.append(r', T_{{\rm g},0}')
            self._oceanic_var_string.append('T_g_0')
        for i in range(1, self.nmod[1] + 1):
            self._ground_latex_var_string.append(r'delta T_{\rm g,' + str(i) + "}")
            self._ground_var_string.append('delta_T_g_' + str(i))

    # -- analytic wavenumber-block setters (ref ``params.py:1824-1965``) ---

    @property
    def ablocks(self):
        return self._ams

    @ablocks.setter
    def ablocks(self, value):
        self._ams = value
        self._atmospheric_basis = ChannelFourierBasis(self._ams, float(self.scale_params.n))
        namod = sum(3 if self._ams[i, 0] == 1 else 2 for i in range(self._ams.shape[0]))
        self._number_of_atmospheric_modes = namod
        if self.ground_params is not None:
            self.ground_params.orographic_basis = 'atmospheric'
            self.ground_params.set_orography(namod * [0.e0])
            self.ground_params.set_orography(0.1, 1)
        if self.atemperature_params is not None:
            self.atemperature_params.set_thetas(namod * [0.e0])
            self.atemperature_params.set_thetas(0.1, 0)

    @property
    def oblocks(self):
        return self._oms

    @oblocks.setter
    def oblocks(self, value):
        self._oms = value
        self._gms = None
        self._oceanic_basis = BasinFourierBasis(self._oms, float(self.scale_params.n))
        self._ground_basis = None
        self._activate_heat_exchange()
        # analytic path's heat-exchange activation keeps non-dynamic defaults
        if self.atemperature_params is not None:
            self.atemperature_params.T0 = Parameter(
                270.0, units='[K]', scale_object=self.scale_params, return_dimensional=True,
                description="stationary solution for the 0-th order atmospheric temperature",
                symbol=Symbol('T_a0'))
        if self.gotemperature_params is not None:
            self._number_of_ground_modes = 0
            self._number_of_oceanic_modes = self._oms.shape[0]
            self.gotemperature_params.set_insolation(self.nmod[0] * [0.e0])
            self.gotemperature_params.set_insolation(350.0, 0)
            self.gotemperature_params.T0 = Parameter(
                285.0, units='[K]', scale_object=self.scale_params, return_dimensional=True,
                description="stationary solution for the 0-th order oceanic temperature",
                symbol=Symbol('T_go0'))
            if self.ground_params is not None:
                self.ground_params.hk = None

    @property
    def gblocks(self):
        return self._gms

    @gblocks.setter
    def gblocks(self, value):
        self._oms = None
        self._gms = value
        self._oceanic_basis = None
        self._ground_basis = ChannelFourierBasis(self._gms, float(self.scale_params.n))
        self._activate_heat_exchange()
        if self.atemperature_params is not None:
            self.atemperature_params.T0 = Parameter(
                270.0, units='[K]', scale_object=self.scale_params, return_dimensional=True,
                description="stationary solution for the 0-th order atmospheric temperature",
                symbol=Symbol('T_a0'))
        if self.gotemperature_params is not None:
            gmod = sum(3 if self._gms[i, 0] == 1 else 2 for i in range(self._gms.shape[0]))
            self._number_of_ground_modes = gmod
            self._number_of_oceanic_modes = 0
            if self.ground_params is not None:
                self.ground_params.orographic_basis = 'atmospheric'
                if self.ground_params.hk is None:
                    self.ground_params.set_orography(self.nmod[0] * [0.e0])
                    self.ground_params.set_orography(0.1, 1)
            self.gotemperature_params.set_insolation(self.nmod[0] * [0.e0])
            self.gotemperature_params.set_insolation(350.0, 0)
            self.gotemperature_params.T0 = Parameter(
                285.0, units='[K]', scale_object=self.scale_params, return_dimensional=True,
                description="stationary solution for the 0-th order oceanic temperature",
                symbol=Symbol('T_go0'))

    # -- high-level mode configuration helpers -----------------------------

    @staticmethod
    def _contiguous_blocks(nxmax, nymax):
        res = np.zeros((nxmax * nymax, 2), dtype=int)
        i = 0
        for nx in range(1, nxmax + 1):
            for ny in range(1, nymax + 1):
                res[i] = (nx, ny)
                i += 1
        return res

    def set_atmospheric_channel_fourier_modes(self, nxmax, nymax, auto=False, mode='analytic'):
        """Contiguous channel modes up to (nxmax, nymax) for the atmosphere."""
        if mode == 'symbolic':
            basis = contiguous_channel_basis(nxmax, nymax, float(self.scale_params.n))
            self.set_atmospheric_modes(basis, auto)
        else:
            if auto:
                if self.atemperature_params is None:
                    self.atemperature_params = AtmosphericTemperatureParams(self.scale_params)
                if self.atmospheric_params is None:
                    self.atmospheric_params = AtmosphericParams(self.scale_params)
            self.ablocks = self._contiguous_blocks(nxmax, nymax)
            self._atmospheric_var_string = []
            self._atmospheric_latex_var_string = []
            for i in range(self.nmod[0]):
                self._atmospheric_latex_var_string.append(r'psi_{\rm a,' + str(i + 1) + "}")
                self._atmospheric_var_string.append('psi_a_' + str(i + 1))
            for i in range(self.nmod[0]):
                self._atmospheric_latex_var_string.append(r'theta_{\rm a,' + str(i + 1) + "}")
                self._atmospheric_var_string.append('theta_a_' + str(i + 1))

    def set_oceanic_basin_fourier_modes(self, nxmax, nymax, auto=True, mode='analytic'):
        """Contiguous closed-basin modes up to (nxmax, nymax) for the ocean."""
        if mode == 'symbolic':
            basis = contiguous_basin_basis(nxmax, nymax, float(self.scale_params.n))
            self.set_oceanic_modes(basis, auto)
        else:
            if self._ams is None:
                print('Atmosphere modes not set up. Add an atmosphere before adding an ocean!')
                return
            if auto:
                if self.gotemperature_params is None or isinstance(self.gotemperature_params,
                                                                   GroundTemperatureParams):
                    self.gotemperature_params = OceanicTemperatureParams(self.scale_params)
                if self.oceanic_params is None:
                    self.oceanic_params = OceanicParams(self.scale_params)
                self.ground_params = None
            self.oblocks = self._contiguous_blocks(nxmax, nymax)
            self._oceanic_var_string = []
            self._oceanic_latex_var_string = []
            self._ground_var_string = []
            self._ground_latex_var_string = []
            for i in range(self.nmod[1]):
                self._oceanic_latex_var_string.append(r'psi_{\rm o,' + str(i + 1) + "}")
                self._oceanic_var_string.append('psi_o_' + str(i + 1))
            for i in range(self.nmod[1]):
                self._oceanic_latex_var_string.append(r'delta T_{\rm o,' + str(i + 1) + "}")
                self._oceanic_var_string.append('delta_T_o_' + str(i + 1))

    def set_ground_channel_fourier_modes(self, nxmax=None, nymax=None, auto=True, mode='analytic'):
        """Contiguous channel modes for the ground (defaults to the atmospheric blocks)."""
        if mode == 'symbolic':
            basis = (contiguous_channel_basis(nxmax, nymax, float(self.scale_params.n))
                     if (nxmax is not None and nymax is not None) else None)
            self.set_ground_modes(basis, auto)
        else:
            if self._ams is None:
                print('Atmosphere modes not set up. Add an atmosphere before adding the ground!')
                return
            res = (self._ams.copy() if (nxmax is None or nymax is None)
                   else self._contiguous_blocks(nxmax, nymax))
            if auto:
                if self.gotemperature_params is None or isinstance(self.gotemperature_params,
                                                                   OceanicTemperatureParams):
                    self.gotemperature_params = GroundTemperatureParams(self.scale_params)
                if self.ground_params is None:
                    self.ground_params = GroundParams(self.scale_params)
                self.oceanic_params = None
            self.gblocks = res
            self._oceanic_var_string = []
            self._oceanic_latex_var_string = []
            self._ground_var_string = []
            self._ground_latex_var_string = []
            for i in range(self.nmod[1]):
                self._ground_latex_var_string.append(r'delta T_{\rm g,' + str(i + 1) + "}")
                self._ground_var_string.append('delta_T_g_' + str(i + 1))
