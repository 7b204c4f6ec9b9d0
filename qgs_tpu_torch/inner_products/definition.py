"""
Inner-product definitions
=========================

User-overridable definition of the inner product used for the Galerkin
projection (ref ``qgs/inner_products/definition.py:22-405``).
The standard definition is

    (S, G) = n/(2 pi^2) * int_0^pi int_0^{2 pi/n} S(x,y) G(x,y) dx dy

but custom weighted products (e.g. exponentially weighted in y) can be
defined by subclassing :class:`SymbolicInnerProductDefinition` — both the
SymPy exact engine and the vectorized quadrature engine consume the
definition through the same interface.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from sympy import diff, integrate, pi, symbols, Integral
from sympy.simplify.fu import TR8, TR10

_x, _y = symbols('x y')
_n = symbols('n', positive=True)


class InnerProductDefinition(ABC):
    """Base class: differential operators + an integrand optimizer."""

    def __init__(self, optimizer=None):
        if optimizer is None:
            self.set_optimizer(self._no_optimizer)
        else:
            self.set_optimizer(optimizer)

    def set_optimizer(self, optimizer):
        """Set the integrand/integral optimizer callable
        (ref ``qgs/inner_products/definition.py:48-55``)."""
        self.optimizer = optimizer

    @staticmethod
    def _no_optimizer(expr):
        return expr

    @staticmethod
    def jacobian(S, G):
        """Advection Jacobian J(S, G) = dS/dx dG/dy - dG/dx dS/dy."""
        return diff(S, _x) * diff(G, _y) - diff(G, _x) * diff(S, _y)

    @staticmethod
    def laplacian(S):
        """2-D Laplacian."""
        return diff(S, _x, 2) + diff(S, _y, 2)

    @abstractmethod
    def symbolic_inner_product(self, S, G, symbolic_expr=False, integrand=False):
        """Definition of the product (S, G)."""

    # Derived-product contract of the coefficient algebra
    # (abstract in the reference base class, ``definition.py:81-147``).

    @abstractmethod
    def ip_lap(self, S, G, symbolic_expr=False, integrand=False):
        """(S, lap G)."""

    @abstractmethod
    def ip_diff_x(self, S, G, symbolic_expr=False, integrand=False):
        """(S, dG/dx)."""

    @abstractmethod
    def ip_jac(self, S, G, H, symbolic_expr=False, integrand=False):
        """(S, J(G, H))."""

    @abstractmethod
    def ip_jac_lap(self, S, G, H, symbolic_expr=False, integrand=False):
        """(S, J(G, lap H))."""


class SymbolicInnerProductDefinition(InnerProductDefinition):
    """Adds the derived products used by the coefficient algebra."""

    def ip_lap(self, S, G, symbolic_expr=False, integrand=False):
        """(S, lap G)."""
        return self.symbolic_inner_product(S, self.laplacian(G),
                                           symbolic_expr=symbolic_expr,
                                           integrand=integrand)

    def ip_diff_x(self, S, G, symbolic_expr=False, integrand=False):
        """(S, dG/dx)."""
        return self.symbolic_inner_product(S, diff(G, _x),
                                           symbolic_expr=symbolic_expr,
                                           integrand=integrand)

    def ip_jac(self, S, G, H, symbolic_expr=False, integrand=False):
        """(S, J(G, H))."""
        return self.symbolic_inner_product(S, self.jacobian(G, H),
                                           symbolic_expr=symbolic_expr,
                                           integrand=integrand)

    def ip_jac_lap(self, S, G, H, symbolic_expr=False, integrand=False):
        """(S, J(G, lap H))."""
        return self.symbolic_inner_product(S, self.jacobian(G, self.laplacian(H)),
                                           symbolic_expr=symbolic_expr,
                                           integrand=integrand)


class StandardSymbolicInnerProductDefinition(SymbolicInnerProductDefinition):
    """The standard qgs inner product on the channel/basin domain."""

    def __init__(self, optimizer=None):
        if optimizer is None:
            SymbolicInnerProductDefinition.__init__(self, self._trig_optimizer)
        else:
            SymbolicInnerProductDefinition.__init__(self, optimizer)

    @staticmethod
    def _trig_optimizer(expr):
        return TR10(TR8(expr))

    @staticmethod
    def integrate_over_domain(expr, symbolic_expr=False):
        """n/(2 pi^2) normalized integral over the domain."""
        if symbolic_expr:
            return Integral(expr, (_x, 0, 2 * pi / _n), (_y, 0, pi))
        return integrate(expr, (_x, 0, 2 * pi / _n), (_y, 0, pi))

    def symbolic_inner_product(self, S, G, symbolic_expr=False, integrand=False):
        expr = (_n / (2 * pi ** 2)) * S * G
        if integrand:
            return expr, (_x, 0, 2 * pi / _n), (_y, 0, pi)
        return self.integrate_over_domain(self.optimizer(expr),
                                          symbolic_expr=symbolic_expr)

    # --- hooks for the vectorized quadrature engine -----------------------

    #: weight function W(x, y) multiplying S*G in the integrand (SymPy expr);
    #: the standard product is unweighted.
    weight = None

    #: normalization prefactor as a function of the aspect ratio n
    @staticmethod
    def normalization(n):
        import numpy as np

        return float(n) / (2 * np.pi ** 2)
