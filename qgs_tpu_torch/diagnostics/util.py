"""Diagnostics utility functions (ref ``qgs/diagnostics/util.py:12-45``):
the basis grids are evaluated on the host, with NumPy."""

from __future__ import annotations

import numpy as np


def create_grid_basis(basis, X, Y, extra_subs=None):
    """Evaluate a symbolic basis on a grid -> array (nmodes, *X.shape)."""
    out = []
    for func in basis.num_functions(extra_subs):
        grid = func(X, Y)
        if isinstance(grid, (int, float)) or np.ndim(grid) == 0:
            grid = np.ones_like(X) * grid
        out.append(np.broadcast_to(grid, np.shape(X)))
    return np.array(out)
