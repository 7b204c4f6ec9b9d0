"""
Parameter primitives
====================

Unit-aware, optionally-symbolic scalar parameters with automatic
dimensional <-> nondimensional conversion.

The model's equations are nondimensionalized with the characteristic length
``L``, the Coriolis parameter ``f0`` (inverse time) and the layer pressure
difference ``deltap``.  A parameter declares its physical units as a compact
string (e.g. ``'[m^2][s^-2][Pa^-2]'``); only the atoms ``m``, ``s`` and ``Pa``
participate in the conversion — everything else (J, K, kg, W, ...) passes
through and marks the parameter as intrinsically dimensional.

Feature parity with the reference implementation
(``qgs/params/parameter.py:68-1345``): scaling parameters,
parameters, parameter arrays, full arithmetic propagating units and SymPy
symbolic expressions (used by the symbolic-export layer).
"""

from __future__ import annotations

import warnings
from fractions import Fraction

import numpy as np
from sympy import Symbol


# ---------------------------------------------------------------------------
# Unit-string algebra
# ---------------------------------------------------------------------------

def parse_units(units: str) -> dict:
    """Parse a unit string like ``'[m^2][s^-2][Pa^-2]'`` into ``{atom: power}``."""
    if not units:
        return {}
    atoms = {}
    for tok in units.strip("[]").split("]["):
        if not tok:
            continue
        if "^" in tok:
            name, p = tok.split("^")
            power = Fraction(p)
        else:
            name, power = tok, Fraction(1)
        atoms[name] = atoms.get(name, Fraction(0)) + power
    return {k: v for k, v in atoms.items() if v != 0}


def format_units(atoms: dict) -> str:
    """Format an ``{atom: power}`` dict back into a unit string."""
    out = []
    for name, p in atoms.items():
        if p == 1:
            out.append(f"[{name}]")
        else:
            pp = int(p) if p == int(p) else p
            out.append(f"[{name}^{pp}]")
    return "".join(out)


def combine_units(u1: str, u2: str, sign: int = 1) -> str:
    """Combine two unit strings (``sign=+1`` multiply, ``-1`` divide)."""
    a1, a2 = parse_units(u1), parse_units(u2)
    for k, v in a2.items():
        a1[k] = a1.get(k, Fraction(0)) + sign * v
    return format_units({k: v for k, v in a1.items() if v != 0})


def power_units(u: str, p) -> str:
    """Raise a unit string to the power ``p``."""
    pf = Fraction(p).limit_denominator()
    atoms = parse_units(u)
    out = {}
    for k, v in atoms.items():
        new = v * pf
        if new.denominator != 1:
            raise ArithmeticError("only integer exponents are supported in units")
        out[k] = new
    return format_units(out)


def conversion_factor(units: str, scale_object) -> float:
    """Multiplicative factor turning a *dimensional* value into the model's
    *nondimensional* value (reference ``parameter.py:597-617`` semantics):
    ``m^p -> L^-p``, ``s^p -> f0^p``, ``Pa^p -> deltap^-p``."""
    factor = 1.0
    for name, p in parse_units(units).items():
        p = float(p)
        if name == "m":
            factor *= float(scale_object.L) ** (-p)
        elif name == "s":
            factor *= float(scale_object.f0) ** p
        elif name == "Pa":
            factor *= float(scale_object.deltap) ** (-p)
    return factor


# ---------------------------------------------------------------------------
# ScalingParameter
# ---------------------------------------------------------------------------

class ScalingParameter(float):
    """A model scale parameter (L, f0, n, deltap, ...).  Always stores its raw
    value; flagged dimensional or not.  Arithmetic combines units and symbolic
    expressions and yields new :class:`ScalingParameter` objects."""

    def __new__(cls, value, units="", description="", dimensional=False,
                symbol=None, symbolic_expression=None):
        f = float.__new__(cls, value)
        f._units = units
        f._description = description
        f._dimensional = dimensional
        f._symbol = symbol
        f._symbolic_expression = symbolic_expression
        return f

    # -- accessors ---------------------------------------------------------
    @property
    def units(self):
        return self._units

    @property
    def description(self):
        return self._description

    @property
    def dimensional(self):
        return self._dimensional

    @property
    def symbol(self):
        return self._symbol

    @property
    def symbolic_expression(self):
        if self._symbolic_expression is None:
            return self._symbol
        return self._symbolic_expression

    # -- arithmetic --------------------------------------------------------
    def _expr(self):
        return self.symbolic_expression

    @staticmethod
    def _other_expr(other):
        if isinstance(other, (ScalingParameter, Parameter)):
            return other.symbolic_expression
        return other

    def _combine(self, other, value, units, op, rev=False):
        se, oe = self._expr(), self._other_expr(other)
        expr = None
        if se is not None and oe is not None:
            expr = op(oe, se) if rev else op(se, oe)
        desc = self._description
        return ScalingParameter(value, units=units, description=desc,
                                dimensional=bool(parse_units(units)) or self._dimensional,
                                symbol=None, symbolic_expression=expr)

    def __mul__(self, other):
        ou = other.units if isinstance(other, (ScalingParameter, Parameter)) else ""
        return self._combine(other, float(self) * float(other),
                             combine_units(self._units, ou, +1), lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        ou = other.units if isinstance(other, (ScalingParameter, Parameter)) else ""
        return self._combine(other, float(self) / float(other),
                             combine_units(self._units, ou, -1), lambda a, b: a / b)

    def __rtruediv__(self, other):
        ou = other.units if isinstance(other, (ScalingParameter, Parameter)) else ""
        return self._combine(other, float(other) / float(self),
                             combine_units(ou, self._units, -1), lambda a, b: a / b, rev=True)

    def __add__(self, other):
        return self._combine(other, float(self) + float(other), self._units, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        return self._combine(other, float(self) - float(other), self._units, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._combine(other, float(other) - float(self), self._units,
                             lambda a, b: a - b, rev=True)

    def __neg__(self):
        return self._combine(0.0, -float(self), self._units, lambda a, b: -a)

    def __pow__(self, p):
        se = self._expr()
        expr = se ** p if se is not None else None
        return ScalingParameter(float(self) ** p, units=power_units(self._units, p),
                                description=f"({self._description})^{p}",
                                dimensional=self._dimensional, symbolic_expression=expr)


# ---------------------------------------------------------------------------
# Parameter
# ---------------------------------------------------------------------------

class Parameter(float):
    """A model parameter.

    The float value stored is the *effective* one — nondimensional unless
    ``return_dimensional`` — converted at construction from whichever form was
    provided (``input_dimensional``).  Immutable.
    """

    def __new__(cls, value, input_dimensional=True, units="", scale_object=None,
                description="", symbol=None, return_dimensional=False,
                symbolic_expression=None):

        no_scale = False
        if return_dimensional:
            if input_dimensional:
                evalue = value
            elif scale_object is None:
                return_dimensional, evalue, no_scale = False, value, True
            else:
                evalue = value / conversion_factor(units, scale_object)
        else:
            if input_dimensional:
                if scale_object is None:
                    return_dimensional, evalue, no_scale = True, value, True
                else:
                    evalue = value * conversion_factor(units, scale_object)
            else:
                evalue = value

        if no_scale:
            warnings.warn("Parameter configured to perform dimensional conversion "
                          "but without a ScaleParams object: conversion disabled!")

        f = float.__new__(cls, evalue)
        f._input_dimensional = input_dimensional
        f._return_dimensional = return_dimensional
        f._units = units
        f._scale_object = scale_object
        f._description = description
        f._symbol = symbol
        f._symbolic_expression = symbolic_expression
        return f

    def __getnewargs_ex__(self):
        # reconstruct on unpickling without re-running the dimensional
        # conversion (the instance __dict__ restores the real flags after)
        return (float(self),), {"input_dimensional": self._return_dimensional,
                                "return_dimensional": self._return_dimensional}

    # -- accessors ---------------------------------------------------------
    @property
    def _nondimensionalization(self):
        if self._scale_object is None:
            return 1.0
        return conversion_factor(self._units, self._scale_object)

    @property
    def dimensional_value(self):
        if self._return_dimensional:
            return float(self)
        return float(self) / self._nondimensionalization

    @property
    def nondimensional_value(self):
        if self._return_dimensional:
            return float(self) * self._nondimensionalization
        return float(self)

    @property
    def input_dimensional(self):
        return self._input_dimensional

    @property
    def return_dimensional(self):
        return self._return_dimensional

    @property
    def units(self):
        return self._units

    @property
    def description(self):
        return self._description

    @property
    def symbol(self):
        return self._symbol

    @property
    def symbolic_expression(self):
        if self._symbolic_expression is None:
            return self._symbol
        return self._symbolic_expression

    # -- arithmetic --------------------------------------------------------
    def _wrap(self, value, units, expr):
        return Parameter(value, input_dimensional=self._return_dimensional,
                         return_dimensional=self._return_dimensional,
                         scale_object=self._scale_object, units=units,
                         description=self._description, symbol=None,
                         symbolic_expression=expr)

    @staticmethod
    def _oexpr(other):
        if isinstance(other, (Parameter, ScalingParameter)):
            return other.symbolic_expression
        return other

    @staticmethod
    def _ounits(other):
        if isinstance(other, (Parameter, ScalingParameter)):
            return other.units
        return ""

    def _binop(self, other, fval, ucomb, fexpr):
        se, oe = self.symbolic_expression, self._oexpr(other)
        expr = fexpr(se, oe) if (se is not None and oe is not None) else None
        try:
            return self._wrap(fval, ucomb, expr)
        except Exception:
            return fval

    def __add__(self, other):
        if isinstance(other, Parameter) and self.units != other.units:
            raise ArithmeticError("cannot add parameters with different units")
        return self._binop(other, float(self) + float(other), self._units, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, Parameter) and self.units != other.units:
            raise ArithmeticError("cannot subtract parameters with different units")
        return self._binop(other, float(self) - float(other), self._units, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._binop(other, float(other) - float(self), self._units, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binop(other, float(self) * float(other),
                           combine_units(self._units, self._ounits(other), +1),
                           lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, float(self) / float(other),
                           combine_units(self._units, self._ounits(other), -1),
                           lambda a, b: a / b)

    def __rtruediv__(self, other):
        return self._binop(other, float(other) / float(self),
                           combine_units(self._ounits(other), self._units, -1),
                           lambda a, b: b / a)

    def __neg__(self):
        se = self.symbolic_expression
        return self._wrap(-float(self), self._units, -se if se is not None else None)

    def __pow__(self, p):
        se = self.symbolic_expression
        expr = se ** p if se is not None else None
        return self._wrap(float(self) ** p, power_units(self._units, p), expr)


# ---------------------------------------------------------------------------
# ParametersArray
# ---------------------------------------------------------------------------

class ParametersArray(np.ndarray):
    """An ndarray of :class:`Parameter` (object dtype) representing a spectral
    decomposition (insolation, orography, theta-star, ...)."""

    def __new__(cls, values, units="", scale_object=None, description=None,
                symbols=None, input_dimensional=True, return_dimensional=False):
        values = list(values)
        n = len(values)
        if description is None:
            description = n * [""]
        elif isinstance(description, str):
            description = n * [description]
        if symbols is None:
            symbols = n * [None]
        params = [
            v if isinstance(v, Parameter) else Parameter(
                v, units=units, scale_object=scale_object, description=description[i],
                symbol=symbols[i], input_dimensional=input_dimensional,
                return_dimensional=return_dimensional)
            for i, v in enumerate(values)
        ]
        obj = np.asarray(params, dtype=object).view(cls)
        return obj

    @property
    def values(self):
        """Effective float values as a plain float64 ndarray."""
        return np.array([float(v) for v in self], dtype=np.float64)

    @property
    def symbols(self):
        return [getattr(v, "symbol", None) for v in self]

    # -- reference parity accessors (ref ``qgs/params/parameter.py:1075-1150``)

    @property
    def dimensional_values(self):
        """Dimensional values of the parameters as a float64 ndarray."""
        return np.array([v.dimensional_value if isinstance(v, Parameter)
                         else float(v) for v in self], dtype=np.float64)

    @property
    def nondimensional_values(self):
        """Nondimensional values of the parameters as a float64 ndarray."""
        return np.array([v.nondimensional_value if isinstance(v, Parameter)
                         else float(v) for v in self], dtype=np.float64)

    @property
    def symbolic_expressions(self):
        """Symbolic expressions of the parameters (object ndarray)."""
        out = np.empty(len(self), dtype=object)
        for i, v in enumerate(self):
            out[i] = getattr(v, "symbolic_expression", None)
        return out

    @property
    def descriptions(self):
        """Descriptions of the parameters (object ndarray)."""
        out = np.empty(len(self), dtype=object)
        for i, v in enumerate(self):
            out[i] = getattr(v, "description", "")
        return out

    @property
    def input_dimensional(self):
        """bool: whether the provided values were dimensional."""
        return all(getattr(v, "input_dimensional", False) for v in self)

    @property
    def return_dimensional(self):
        """bool: whether the effective float values are dimensional."""
        return all(getattr(v, "return_dimensional", False) for v in self)

    @property
    def units(self):
        """str: common unit string of the parameters."""
        for v in self:
            u = getattr(v, "units", "")
            if u:
                return u
        return ""
