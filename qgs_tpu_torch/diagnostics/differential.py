"""
Differential field diagnostics machinery
========================================

Field diagnostics whose mode grids are derivatives of the basis functions
(ref ``qgs/diagnostics/differential.py:27-120``): the symbolic basis is
differentiated once with SymPy and evaluated on the host grid, and the
grids are uploaded once, after which every trajectory reconstruction stays
one product on the device.
"""

from __future__ import annotations

from qgs_tpu_torch.diagnostics.base import FieldDiagnostic
from qgs_tpu_torch.diagnostics.util import create_grid_basis


class DifferentialFieldDiagnostic(FieldDiagnostic):
    """Field diagnostic built on dx/dy-differentiated basis grids."""

    def _configure_differential_grid(self, basis, kind, order=1,
                                     delta_x=None, delta_y=None):
        self._compute_grid(delta_x, delta_y)
        if kind == "dx":
            dbasis = basis.x_derivative(order)
        elif kind == "dy":
            dbasis = basis.y_derivative(order)
        else:
            raise ValueError(kind)
        self._grid_basis = self._to_device(
            create_grid_basis(dbasis, self._X, self._Y))


class LaplacianFieldDiagnostic(FieldDiagnostic):
    """Field diagnostic built on Laplacian-of-basis grids."""

    def _configure_laplacian_grid(self, basis, delta_x=None, delta_y=None):
        self._compute_grid(delta_x, delta_y)
        gxx = create_grid_basis(basis.x_derivative(2), self._X, self._Y)
        gyy = create_grid_basis(basis.y_derivative(2), self._X, self._Y)
        self._grid_basis = self._to_device(gxx + gyy)
