"""
Basis definition (base classes)
===============================

Bases of 2D mode functions used for the Galerkin projection of the model's
PDEs (ref ``qgs/basis/base.py:32-213``).  A
:class:`SymbolicBasis` holds SymPy expressions in the nondimensional domain
coordinates ``(x, y)`` plus a substitution list (e.g. the aspect ratio
``n``); it can be lambdified for numerical (grid) evaluation, which in this
framework feeds directly into batched ``einsum`` field reconstructions.
"""

from __future__ import annotations

from abc import ABC

import numpy as np
from sympy import diff, lambdify, symbols


class Basis(ABC):
    """A list of basis functions."""

    def __init__(self):
        self.functions = list()

    def __getitem__(self, index):
        return self.functions[index]

    def __len__(self):
        return len(self.functions)

    def __delitem__(self, key):
        del self.functions[key]

    def __repr__(self):
        return repr(self.functions)

    def __str__(self):
        return str(self.functions)

    def append(self, item):
        self.functions.append(item)


class SymbolicBasis(Basis):
    """A basis of SymPy expressions with stored substitutions."""

    def __init__(self):
        Basis.__init__(self)
        self.substitutions = list()

    def subs_functions(self, extra_subs=None):
        """Basis functions with the stored (and extra) substitutions applied."""
        sf = []
        for f in self.functions:
            ff = f.subs(extra_subs) if extra_subs is not None else f
            sf.append(ff.subs(self.substitutions))
        return sf

    def num_functions(self, extra_subs=None):
        """Basis functions as python callables ``f(x, y)``."""
        x, y = symbols('x y')
        return [lambdify([x, y], f, modules='numpy') for f in self.subs_functions(extra_subs)]

    def derivative(self, symbol, order=1):
        """New basis of the functions differentiated w.r.t. ``symbol``."""
        dbasis = SymbolicBasis()
        dbasis.functions = [diff(f, symbol, order) for f in self.functions]
        dbasis.substitutions = list(self.substitutions)
        return dbasis

    def x_derivative(self, order=1):
        return self.derivative(symbols('x'), order)

    def y_derivative(self, order=1):
        return self.derivative(symbols('y'), order)

    def grid_values(self, X, Y, extra_subs=None):
        """Evaluate every basis function on a grid -> array (nmodes, *X.shape).

        This is the host-side half of field reconstruction; the device-side
        half is a single ``einsum('ti,iyx->tyx')`` contraction.
        """
        nf = self.num_functions(extra_subs)
        out = np.empty((len(nf),) + np.shape(X), dtype=np.float64)
        for i, f in enumerate(nf):
            out[i] = np.broadcast_to(f(X, Y), np.shape(X))
        return out


class NumericBasis(Basis):
    """A basis of plain python callables."""

    def num_functions(self):
        return self.functions
