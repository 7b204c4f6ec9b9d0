"""
Inner products (abstract contracts)
===================================

Coefficient-algebra contracts consumed by the tendency-tensor assembly
(ref ``qgs/inner_products/base.py:30-338``):

* atmosphere: ``a, u, b, c, g, s, d`` (+ quartic ``z, v``, + ``gh`` for a
  non-atmospheric orographic basis)
* ocean:      ``M, U, N, O, C, K, W`` (+ quartic ``Z, V``)
* ground:     subset (``U, W`` defined; the rest zero)

Concrete subclasses store dense NumPy arrays ``_a, _u, ...`` (the mode
counts are small enough that dense host arrays dominate COO bookkeeping)
and the rank-5 quartic coefficients as :class:`~qgs_tpu_torch.utils.sparse.COO`.
"""

from __future__ import annotations

import pickle

from abc import ABC, abstractmethod


class InnerProducts(ABC):
    """Shared persistence helpers."""

    def save_to_file(self, filename, **kwargs):
        with open(filename, 'wb') as f:
            pickle.dump(self.__dict__, f, **kwargs)

    def load_from_file(self, filename, **kwargs):
        with open(filename, 'rb') as f:
            tmp = pickle.load(f, **kwargs)
        self.__dict__.clear()
        self.__dict__.update(tmp)


class AtmosphericInnerProducts(InnerProducts):
    """Atmospheric inner-products contract."""

    def __init__(self):
        self._a = None      # (F_i, lap F_j)
        self._u = None      # (F_i, F_j)
        self._b = None      # (F_i, J(F_j, lap F_k))
        self._c = None      # (F_i, dx F_j)
        self._g = None      # (F_i, J(F_j, F_k))
        self._gh = None     # (F_i, J(F_j, phi_k)) for non-atmospheric orography
        self._s = None      # (F_i, phi_j)
        self._d = None      # (F_i, lap phi_j)
        self._z = None      # (F_i, F_j F_k F_l F_m)       [rank-5, T4]
        self._v = None      # (F_i, phi_j phi_k phi_l phi_m) [rank-5, T4]

    @property
    @abstractmethod
    def natm(self):
        """Number of atmospheric modes (ref ``qgs/inner_products/base.py:52``)."""

    @abstractmethod
    def a(self, i, j): ...

    @abstractmethod
    def u(self, i, j): ...

    @abstractmethod
    def b(self, i, j, k): ...

    @abstractmethod
    def c(self, i, j): ...

    @abstractmethod
    def g(self, i, j, k): ...

    @abstractmethod
    def s(self, i, j): ...

    @abstractmethod
    def d(self, i, j): ...

    def z(self, i, j, k, l, m):
        return None

    def v(self, i, j, k, l, m):
        return None

    def gh(self, i, j, k):
        return None


class OceanicInnerProducts(InnerProducts):
    """Oceanic inner-products contract."""

    def __init__(self):
        self._M = None      # (phi_i, lap phi_j)
        self._U = None      # (phi_i, phi_j)
        self._N = None      # (phi_i, dx phi_j)
        self._O = None      # (phi_i, J(phi_j, phi_k))
        self._C = None      # (phi_i, J(phi_j, lap phi_k))
        self._K = None      # (phi_i, lap F_j)
        self._W = None      # (phi_i, F_j)
        self._Z = None      # (phi_i, F_j F_k F_l F_m)       [rank-5, T4]
        self._V = None      # (phi_i, phi_j phi_k phi_l phi_m) [rank-5, T4]

    @property
    @abstractmethod
    def noc(self):
        """Number of oceanic modes (ref ``qgs/inner_products/base.py:157``)."""

    @abstractmethod
    def M(self, i, j): ...

    @abstractmethod
    def U(self, i, j): ...

    @abstractmethod
    def N(self, i, j): ...

    @abstractmethod
    def O(self, i, j, k): ...

    @abstractmethod
    def C(self, i, j, k): ...

    @abstractmethod
    def K(self, i, j): ...

    @abstractmethod
    def W(self, i, j): ...

    def Z(self, i, j, k, l, m):
        return None

    def V(self, i, j, k, l, m):
        return None


class GroundInnerProducts(InnerProducts):
    """Ground inner-products contract (only ``U`` and ``W`` are nontrivial)."""

    def __init__(self):
        self._U = None
        self._W = None
        self._Z = None
        self._V = None

    @property
    @abstractmethod
    def ngr(self):
        """Number of ground modes (ref ``qgs/inner_products/base.py:262``)."""

    @abstractmethod
    def U(self, i, j): ...

    @abstractmethod
    def W(self, i, j): ...

    def K(self, i, j):
        return 0

    def M(self, i, j):
        return 0

    def N(self, i, j):
        return 0

    def O(self, i, j, k):
        return 0

    def C(self, i, j, k):
        return 0

    def Z(self, i, j, k, l, m):
        return None

    def V(self, i, j, k, l, m):
        return None
