"""
Temperature diagnostics
=======================

Atmospheric / oceanic / ground temperature fields, anomalies and meridional
gradients (ref ``qgs/diagnostics/temperatures.py:32-705``).

Conventions: the middle-atmosphere temperature anomaly is
``delta T_a = 2 theta_a`` (thermal-wind relation), dimensionalized by the
temperature scaling; the ocean/ground anomalies are the delta-T variables
dimensionalized without the factor 2.
"""

from __future__ import annotations

import torch

from qgs_tpu_torch.diagnostics.base import FieldDiagnostic
from qgs_tpu_torch.diagnostics.differential import DifferentialFieldDiagnostic


class AtmosphericTemperatureDiagnostic(FieldDiagnostic):
    """Base class for atmospheric temperature fields."""

    def __init__(self, model_params, delta_x=None, delta_y=None,
                 dimensional=True, device="cuda"):
        FieldDiagnostic.__init__(self, model_params, dimensional, device)
        self._configure_grid_basis(model_params.atmospheric_basis, delta_x,
                                   delta_y)

    def _theta_field(self):
        o = self._offset
        vr = self._model_params.variables_range
        return self._reconstruct(self._data[vr[0] + o:vr[1]], self._grid_basis[o:])


class MiddleAtmosphericTemperatureAnomalyDiagnostic(AtmosphericTemperatureDiagnostic):
    """delta T_a = 2 theta_a at 500 hPa."""

    def __init__(self, model_params, delta_x=None, delta_y=None,
                 dimensional=True, device="cuda"):
        AtmosphericTemperatureDiagnostic.__init__(
            self, model_params, delta_x, delta_y, dimensional, device)
        self._plot_title = r'Atmospheric temperature anomaly $\delta T_{\rm a}$'
        self._plot_units = r" (in K)"
        self._default_plot_kwargs = {'cmap': 'coolwarm'}

    def _get_diagnostic(self, dimensional):
        theta = self._theta_field()
        if dimensional:
            theta = theta * float(self._model_params.temperature_scaling) * 2
        self._diagnostic_data = theta
        self._diagnostic_data_dimensional = dimensional
        return theta


class MiddleAtmosphericTemperatureDiagnostic(AtmosphericTemperatureDiagnostic):
    """Total T_a = T_a0 + delta T_a (reference or dynamic 0-th order T)."""

    def __init__(self, model_params, delta_x=None, delta_y=None,
                 dimensional=True, device="cuda"):
        AtmosphericTemperatureDiagnostic.__init__(
            self, model_params, delta_x, delta_y, dimensional, device)
        self._plot_title = r'Atmospheric temperature $T_{\rm a}$'
        self._plot_units = r" (in K)"
        self._default_plot_kwargs = {'cmap': 'coolwarm'}

    def _T0_series(self):
        """The 0-th order temperature: dynamic variable or fixed parameter
        (nondimensional), one value a record."""
        mp = self._model_params
        n = self._data.shape[-1]
        if mp.dynamic_T:
            vr = mp.variables_range
            return self._data[vr[0], :]          # T_a0 variable
        T0 = mp.atemperature_params.T0
        if T0 is None:
            # Newtonian-cooling configurations have no reference temperature:
            # the "total" temperature degrades to the anomaly
            return torch.zeros(n, dtype=self._data.dtype, device=self.device)
        return torch.full((n,), float(T0) / (float(mp.temperature_scaling) * 2),
                          dtype=self._data.dtype, device=self.device)

    def _get_diagnostic(self, dimensional):
        theta = self._theta_field()
        T0 = self._T0_series()
        # total temperature: anomaly + homogeneous 0-th order part
        field = theta + T0[:, None, None]
        if dimensional:
            field = field * float(self._model_params.temperature_scaling) * 2
        self._diagnostic_data = field
        self._diagnostic_data_dimensional = dimensional
        return field


class OceanicTemperatureDiagnostic(FieldDiagnostic):
    """Base class for oceanic temperature fields."""

    def __init__(self, model_params, delta_x=None, delta_y=None,
                 dimensional=True, device="cuda"):
        FieldDiagnostic.__init__(self, model_params, dimensional, device)
        self._configure_grid_basis(model_params.oceanic_basis, delta_x, delta_y)

    def _deltaT_field(self):
        o = self._offset
        vr = self._model_params.variables_range
        return self._reconstruct(self._data[vr[2] + o:vr[3]], self._grid_basis[o:])


class OceanicLayerTemperatureAnomalyDiagnostic(OceanicTemperatureDiagnostic):
    """Oceanic temperature anomaly delta T_o."""

    def __init__(self, model_params, delta_x=None, delta_y=None,
                 dimensional=True, device="cuda"):
        OceanicTemperatureDiagnostic.__init__(
            self, model_params, delta_x, delta_y, dimensional, device)
        self._plot_title = r'Oceanic temperature anomaly $\delta T_{\rm o}$'
        self._plot_units = r" (in K)"
        self._default_plot_kwargs = {'cmap': 'coolwarm'}

    def _get_diagnostic(self, dimensional):
        dT = self._deltaT_field()
        if dimensional:
            dT = dT * float(self._model_params.temperature_scaling)
        self._diagnostic_data = dT
        self._diagnostic_data_dimensional = dimensional
        return dT


class OceanicLayerTemperatureDiagnostic(OceanicTemperatureDiagnostic):
    """Total oceanic temperature T_o = T_o0 + delta T_o."""

    def __init__(self, model_params, delta_x=None, delta_y=None,
                 dimensional=True, device="cuda"):
        OceanicTemperatureDiagnostic.__init__(
            self, model_params, delta_x, delta_y, dimensional, device)
        self._plot_title = r'Oceanic temperature $T_{\rm o}$'
        self._plot_units = r" (in K)"
        self._default_plot_kwargs = {'cmap': 'coolwarm'}

    def _get_diagnostic(self, dimensional):
        mp = self._model_params
        dT = self._deltaT_field()
        if mp.dynamic_T:
            vr = mp.variables_range
            T0 = self._data[vr[2], :]
            dT = dT + T0[:, None, None]
            if dimensional:
                dT = dT * float(mp.temperature_scaling)
        else:
            if dimensional:
                dT = dT * float(mp.temperature_scaling) + float(mp.gotemperature_params.T0)
            else:
                dT = dT + float(mp.gotemperature_params.T0) / float(mp.temperature_scaling)
        self._diagnostic_data = dT
        self._diagnostic_data_dimensional = dimensional
        return dT


class GroundTemperatureAnomalyDiagnostic(FieldDiagnostic):
    """Ground temperature anomaly delta T_g."""

    def __init__(self, model_params, delta_x=None, delta_y=None,
                 dimensional=True, device="cuda"):
        FieldDiagnostic.__init__(self, model_params, dimensional, device)
        self._set_orography(self._configure_grid_basis(
            model_params.ground_basis, delta_x, delta_y))
        self._plot_title = r'Ground temperature anomaly $\delta T_{\rm g}$'
        self._plot_units = r" (in K)"
        self._default_plot_kwargs = {'cmap': 'coolwarm'}

    def _get_diagnostic(self, dimensional):
        o = self._offset
        vr = self._model_params.variables_range
        dT = self._reconstruct(self._data[vr[1] + o:vr[2]], self._grid_basis[o:])
        if dimensional:
            dT = dT * float(self._model_params.temperature_scaling)
        self._diagnostic_data = dT
        self._diagnostic_data_dimensional = dimensional
        return dT


class GroundTemperatureDiagnostic(GroundTemperatureAnomalyDiagnostic):
    """Total ground temperature T_g = T_g0 + delta T_g, where T_g0 is the
    reference temperature or the 0-th order dynamic temperature
    (ref ``qgs/diagnostics/temperatures.py:506-560``)."""

    def __init__(self, model_params, delta_x=None, delta_y=None,
                 dimensional=True, device="cuda"):
        GroundTemperatureAnomalyDiagnostic.__init__(
            self, model_params, delta_x, delta_y, dimensional, device)
        self._plot_title = r'Ground temperature $T_{\rm g}$'

    def _get_diagnostic(self, dimensional):
        mp = self._model_params
        o = self._offset
        vr = mp.variables_range
        dT = self._reconstruct(self._data[vr[1] + o:vr[2]], self._grid_basis[o:])
        if mp.dynamic_T:
            T0 = self._data[vr[1], :]
            dT = dT + T0[:, None, None]
            if dimensional:
                dT = dT * float(mp.temperature_scaling)
        else:
            if dimensional:
                dT = dT * float(mp.temperature_scaling) + float(mp.gotemperature_params.T0)
            else:
                dT = dT + float(mp.gotemperature_params.T0) / float(mp.temperature_scaling)
        self._diagnostic_data = dT
        self._diagnostic_data_dimensional = dimensional
        return dT


class AtmosphericTemperatureMeridionalGradientDiagnostic(DifferentialFieldDiagnostic):
    """Meridional gradient of the middle-atmosphere temperature
    d(delta T_a)/dy."""

    def __init__(self, model_params, delta_x=None, delta_y=None,
                 dimensional=True, device="cuda"):
        DifferentialFieldDiagnostic.__init__(self, model_params, dimensional,
                                             device)
        self._configure_differential_grid(model_params.atmospheric_basis, "dy",
                                          1, delta_x, delta_y)
        self._plot_title = r'Atmospheric temperature meridional gradient'
        self._plot_units = r" (in K m$^{-1}$)"
        self._default_plot_kwargs = {'cmap': 'coolwarm'}

    def _get_diagnostic(self, dimensional):
        o = self._offset
        vr = self._model_params.variables_range
        grad = self._reconstruct(self._data[vr[0] + o:vr[1]], self._grid_basis[o:])
        if dimensional:
            grad = grad * (float(self._model_params.temperature_scaling) * 2
                           / float(self._model_params.scale_params.L))
        self._diagnostic_data = grad
        self._diagnostic_data_dimensional = dimensional
        return grad


class MiddleAtmosphericTemperatureMeridionalGradientDiagnostic(
        AtmosphericTemperatureMeridionalGradientDiagnostic):
    """Meridional gradient of the 500 hPa atmospheric temperature
    d(T_a)/dy = 2 d(theta_a)/dy, i.e. the thermal-wind gradient
    (ref ``qgs/diagnostics/temperatures.py:635-705``)."""

    def __init__(self, model_params, delta_x=None, delta_y=None,
                 dimensional=True, device="cuda"):
        AtmosphericTemperatureMeridionalGradientDiagnostic.__init__(
            self, model_params, delta_x, delta_y, dimensional, device)
        self._plot_title = r'Atmospheric 500hPa Temperature Meridional Gradient'
