"""
Wind diagnostics
================

Horizontal wind components per atmospheric layer (U = -d psi/dy,
V = d psi/dx), wind intensity, and the mid-layer vertical velocity omega
diagnosed from the difference between the full and the thermodynamic-only
temperature tendencies (ref ``qgs/diagnostics/wind.py:35-758``).
"""

from __future__ import annotations

import torch

from qgs_tpu_torch.diagnostics.differential import DifferentialFieldDiagnostic
from qgs_tpu_torch.diagnostics.util import create_grid_basis
from qgs_tpu_torch.models.tendencies import (create_atmo_thermo_tendencies,
                                             create_tendencies)


class AtmosphericWindDiagnostic(DifferentialFieldDiagnostic):
    """Base class for atmospheric wind fields.  ``self.type`` in
    {'U', 'V', 'W', None} selects the derivative grid."""

    type = None

    def __init__(self, model_params, delta_x=None, delta_y=None,
                 dimensional=True, device="cuda"):
        DifferentialFieldDiagnostic.__init__(self, model_params, dimensional,
                                             device)
        basis = model_params.atmospheric_basis
        if self.type == "V":
            self._configure_differential_grid(basis, "dx", 1, delta_x, delta_y)
        elif self.type == "U":
            self._configure_differential_grid(basis, "dy", 1, delta_x, delta_y)
        else:
            self._compute_grid(delta_x, delta_y)
            self._grid_basis = self._to_device(
                create_grid_basis(basis, self._X, self._Y))
        self._plot_units = r" (in m s$^{-1}$)"

    @property
    def _wind_scaling(self):
        mp = self._model_params
        return float(mp.streamfunction_scaling) / float(mp.scale_params.L)

    def _psi_theta_fields(self):
        o = self._offset
        vr = self._model_params.variables_range
        gb = self._grid_basis[o:]
        psi = self._reconstruct(self._data[:vr[0]], gb)
        theta = self._reconstruct(self._data[vr[0] + o:vr[1]], gb)
        return psi, theta


def _wind_class(name, layer, comp, title):
    """Factory for the six layer/component wind diagnostics."""

    sign = -1.0 if comp == "U" else 1.0

    class _Wind(AtmosphericWindDiagnostic):
        type = comp

        def __init__(self, model_params, delta_x=None, delta_y=None,
                     dimensional=True, device="cuda"):
            AtmosphericWindDiagnostic.__init__(
                self, model_params, delta_x, delta_y, dimensional, device)
            self._plot_title = title

        def _get_diagnostic(self, dimensional):
            psi, theta = self._psi_theta_fields()
            if layer == "lower":
                field = psi - theta
            elif layer == "upper":
                field = psi + theta
            else:
                field = psi
            field = sign * field
            if dimensional:
                field = field * self._wind_scaling
            self._diagnostic_data = field
            self._diagnostic_data_dimensional = dimensional
            return field

    _Wind.__name__ = name
    _Wind.__qualname__ = name
    return _Wind


LowerLayerAtmosphericUWindDiagnostic = _wind_class(
    "LowerLayerAtmosphericUWindDiagnostic", "lower", "U",
    r'Atmospheric U wind in the lower layer')
LowerLayerAtmosphericVWindDiagnostic = _wind_class(
    "LowerLayerAtmosphericVWindDiagnostic", "lower", "V",
    r'Atmospheric V wind in the lower layer')
MiddleAtmosphericUWindDiagnostic = _wind_class(
    "MiddleAtmosphericUWindDiagnostic", "middle", "U",
    r'Atmospheric U wind in the middle layer')
MiddleAtmosphericVWindDiagnostic = _wind_class(
    "MiddleAtmosphericVWindDiagnostic", "middle", "V",
    r'Atmospheric V wind in the middle layer')
UpperLayerAtmosphericUWindDiagnostic = _wind_class(
    "UpperLayerAtmosphericUWindDiagnostic", "upper", "U",
    r'Atmospheric U wind in the upper layer')
UpperLayerAtmosphericVWindDiagnostic = _wind_class(
    "UpperLayerAtmosphericVWindDiagnostic", "upper", "V",
    r'Atmospheric V wind in the upper layer')


def _intensity_class(name, ucls, vcls, title):
    class _Intensity(AtmosphericWindDiagnostic):
        type = None

        def __init__(self, model_params, delta_x=None, delta_y=None,
                     dimensional=True, device="cuda"):
            AtmosphericWindDiagnostic.__init__(
                self, model_params, delta_x, delta_y, dimensional, device)
            self._plot_title = title
            self._udiag = ucls(model_params, delta_x, delta_y, dimensional,
                               self.device)
            self._vdiag = vcls(model_params, delta_x, delta_y, dimensional,
                               self.device)

        def _get_diagnostic(self, dimensional):
            self._udiag.set_data(self._time, self._data)
            self._vdiag.set_data(self._time, self._data)
            U = self._udiag._get_diagnostic(dimensional)
            V = self._vdiag._get_diagnostic(dimensional)
            self._diagnostic_data = torch.sqrt(U ** 2 + V ** 2)
            self._diagnostic_data_dimensional = dimensional
            return self._diagnostic_data

    _Intensity.__name__ = name
    _Intensity.__qualname__ = name
    return _Intensity


LowerLayerAtmosphericWindIntensityDiagnostic = _intensity_class(
    "LowerLayerAtmosphericWindIntensityDiagnostic",
    LowerLayerAtmosphericUWindDiagnostic, LowerLayerAtmosphericVWindDiagnostic,
    r'Atmospheric wind intensity in the lower layer')
MiddleAtmosphericWindIntensityDiagnostic = _intensity_class(
    "MiddleAtmosphericWindIntensityDiagnostic",
    MiddleAtmosphericUWindDiagnostic, MiddleAtmosphericVWindDiagnostic,
    r'Atmospheric wind intensity in the middle layer')
UpperLayerAtmosphericWindIntensityDiagnostic = _intensity_class(
    "UpperLayerAtmosphericWindIntensityDiagnostic",
    UpperLayerAtmosphericUWindDiagnostic, UpperLayerAtmosphericVWindDiagnostic,
    r'Atmospheric wind intensity in the upper layer')


class MiddleLayerVerticalVelocity(AtmosphericWindDiagnostic):
    """Vertical velocity omega at 500 hPa, diagnosed as
    ``omega = (f_theta - f_theta_thermo) / sigma_0`` where the two tendency
    functions (the port's, on the diagnostic's device) are evaluated over
    the whole (n_records, ndim) trajectory in one batched call each (the
    reference uses a per-record Numba loop, ``wind.py:706-714``).  The
    theta coefficients are reconstructed on the grids of the theta modes,
    past the 0-th order temperature of a dynamic-T model, as every other
    atmospheric field is."""

    type = "W"

    def __init__(self, model_params, delta_x=None, delta_y=None,
                 dimensional=True, device="cuda"):
        AtmosphericWindDiagnostic.__init__(self, model_params, delta_x,
                                           delta_y, dimensional, device)
        self._plot_title = r'Atmospheric vertical wind in the middle layer'
        self._plot_units = r" (in Pa s$^{-1}$)"
        self._f, _ = create_tendencies(model_params, device=self.device)
        self._f_thermo = create_atmo_thermo_tendencies(model_params,
                                                       device=self.device)

    def set_data(self, time, data):
        states = self._as_data(data).T               # (n_records, ndim)
        tend = self._f.batched(0., states)
        thermo = self._f_thermo.batched(0., states)
        omega = (tend - thermo).T / float(self._model_params.atmospheric_params.sig0)
        self._set_time(time)
        self._data = omega
        self._diagnostic_data = None

    def _get_diagnostic(self, dimensional):
        o = self._offset
        vr = self._model_params.variables_range
        omega = self._reconstruct(self._data[vr[0] + o:vr[1]],
                                  self._grid_basis[o:])
        if dimensional:
            mp = self._model_params
            omega = omega * float(mp.scale_params.deltap) * float(mp.scale_params.f0)
        self._diagnostic_data = omega
        self._diagnostic_data_dimensional = dimensional
        return omega
