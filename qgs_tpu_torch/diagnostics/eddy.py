"""
Eddy heat flux diagnostics
==========================

Middle-atmosphere eddy heat flux ``(T - <T>) (v - <v>)`` as a field and as
a zonally averaged meridional profile (ref ``qgs/diagnostics/eddy.py:26-218``).
"""

from __future__ import annotations

from qgs_tpu_torch.diagnostics.base import FieldDiagnostic, ProfileDiagnostic
from qgs_tpu_torch.diagnostics.temperatures import MiddleAtmosphericTemperatureDiagnostic
from qgs_tpu_torch.diagnostics.wind import MiddleAtmosphericVWindDiagnostic


class MiddleAtmosphericEddyHeatFluxDiagnostic(FieldDiagnostic):
    """Eddy heat flux field T' v' at 500 hPa.  Mean states can be supplied
    from a long reference trajectory (``temp_mean_state``,
    ``vwind_mean_state``: diagnostics holding their own data), otherwise
    the means of the current data are used."""

    def __init__(self, model_params, delta_x=None, delta_y=None,
                 dimensional=True, temp_mean_state=None,
                 vwind_mean_state=None, heat_capacity=None, device="cuda"):
        FieldDiagnostic.__init__(self, model_params, dimensional, device)
        self._configure_grid_basis(model_params.atmospheric_basis, delta_x,
                                   delta_y)
        self._plot_title = r'Atmospheric eddy heat flux'
        self._plot_units = r" (in W m$^{-2}$)" if heat_capacity else r" (in K m s$^{-1}$)"
        self._default_plot_kwargs = {'cmap': 'coolwarm'}
        self._tdiag = MiddleAtmosphericTemperatureDiagnostic(
            model_params, delta_x, delta_y, dimensional, self.device)
        self._vdiag = MiddleAtmosphericVWindDiagnostic(
            model_params, delta_x, delta_y, dimensional, self.device)
        self._temp_mean_state = temp_mean_state
        self._vwind_mean_state = vwind_mean_state
        self._heat_capacity = heat_capacity

    def _get_diagnostic(self, dimensional):
        self._tdiag.set_data(self._time, self._data)
        self._vdiag.set_data(self._time, self._data)
        T = self._tdiag._get_diagnostic(dimensional)
        V = self._vdiag._get_diagnostic(dimensional)
        if self._temp_mean_state is not None:
            Tmean = self._temp_mean_state._get_diagnostic(dimensional).mean(dim=0)
        else:
            Tmean = T.mean(dim=0)
        if self._vwind_mean_state is not None:
            Vmean = self._vwind_mean_state._get_diagnostic(dimensional).mean(dim=0)
        else:
            Vmean = V.mean(dim=0)
        flux = (T - Tmean) * (V - Vmean)
        if self._heat_capacity is not None:
            flux = flux * self._heat_capacity
        self._diagnostic_data = flux
        self._diagnostic_data_dimensional = dimensional
        return flux


class MiddleAtmosphericEddyHeatFluxProfileDiagnostic(ProfileDiagnostic):
    """Zonally averaged meridional profile of the eddy heat flux."""

    def __init__(self, model_params, delta_x=None, delta_y=None,
                 dimensional=True, temp_mean_state=None,
                 vwind_mean_state=None, heat_capacity=None, device="cuda"):
        ProfileDiagnostic.__init__(self, model_params, dimensional, device)
        self._field = MiddleAtmosphericEddyHeatFluxDiagnostic(
            model_params, delta_x, delta_y, dimensional,
            temp_mean_state, vwind_mean_state, heat_capacity, self.device)
        self._plot_title = r'Atmospheric zonally averaged eddy heat flux'
        self._plot_units = self._field._plot_units
        self._axis_label = "$y$"

    def _get_diagnostic(self, dimensional):
        self._field.set_data(self._time, self._data)
        flux = self._field._get_diagnostic(dimensional)
        self._points = self._field.grid[1][:, 0]
        self._diagnostic_data = flux.mean(dim=-1)
        self._diagnostic_data_dimensional = dimensional
        return self._diagnostic_data
