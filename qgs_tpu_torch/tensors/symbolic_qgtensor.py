"""
Symbolic tendency tensors
=========================

Fully symbolic mirror of the tendency tensors (ref
``qgs/tensors/symbolic_qgtensor.py:23-1521``): the same
block assembly as :class:`~qgs_tpu_torch.tensors.qgtensor.QgsTensor` runs over
object arrays of SymPy expressions, keeping the model parameters symbolic.
Used by the symbolic-export branch (continuation software, generated code).

``tensor_dict`` maps coordinate tuples to expressions; ``sub_tensor``
substitutes every parameter except chosen continuation variables.
"""

from __future__ import annotations

import numpy as np
import sympy
from sympy import Symbol

from qgs_tpu_torch.tensors.qgtensor import QgsTensor, QgsTensorDynamicT, QgsTensorT4
from qgs_tpu_torch.params.parameter import Parameter, ScalingParameter, ParametersArray


def collect_parameter_substitutions(params):
    """All (symbol -> float value) substitutions of a QgParams tree,
    including the derived ``L`` and ``beta`` scale symbols."""
    subs = {}

    def add(p):
        sym = getattr(p, 'symbol', None)
        if sym is not None and sym != 0:
            subs[sym] = float(p)

    for container in (params, params.scale_params, params.atmospheric_params,
                      params.atemperature_params, params.oceanic_params,
                      params.ground_params, params.gotemperature_params):
        if container is None:
            continue
        for val in container.__dict__.values():
            if isinstance(val, (Parameter, ScalingParameter)):
                add(val)
            elif isinstance(val, ParametersArray):
                for v in val:
                    add(v)

    add(params.scale_params.L)
    add(params.scale_params.beta)
    return subs


class SymbolicQgsTensor(QgsTensor):
    """Rank-3 tendency tensor with symbolic parameter dependence."""

    _symbolic = True

    def __init__(self, params=None, atmospheric_inner_products=None,
                 oceanic_inner_products=None, ground_inner_products=None):
        self.tensor_dict = None
        self.jac_dic = None
        QgsTensor.__init__(self, params, atmospheric_inner_products,
                           oceanic_inner_products, ground_inner_products)

    def compute_tensor(self):
        dense = self._assemble_dense()
        self.tensor_dict = self._to_dict(dense)
        self.jac_dic = self._jacobian_dict(self.tensor_dict, rank=3)
        self.tensor = None
        self.jacobian_tensor = None

    @staticmethod
    def _to_dict(obj_array):
        out = {}
        if obj_array is None:
            return out
        it = np.nditer(np.zeros(obj_array.shape), flags=['multi_index'])
        flat = obj_array.reshape(-1)
        shape = obj_array.shape
        for flat_idx in range(flat.size):
            v = flat[flat_idx]
            if v is None:
                continue
            expr = sympy.sympify(v)
            if expr != 0:
                out[np.unravel_index(flat_idx, shape)] = expr
        return out

    @staticmethod
    def _jacobian_dict(tensor_dict, rank=3):
        """Sum over all swaps of axis 1 with each trailing axis."""
        jac = {}
        for idx, v in tensor_dict.items():
            keys = [idx]
            for ax in range(2, rank):
                swapped = list(idx)
                swapped[1], swapped[ax] = swapped[ax], swapped[1]
                keys.append(tuple(swapped))
            for k in keys:
                jac[k] = jac.get(k, 0) + v
        return {k: v for k, v in jac.items() if sympy.sympify(v) != 0}

    # -- reference-parity dict helpers (ref ``qgs/tensors/symbolic_qgtensor.py:710-783``)

    @staticmethod
    def remove_dic_zeros(dic):
        """Return a copy of ``dic`` with zero-valued entries removed."""
        return {k: v for k, v in dic.items() if v != 0}

    @staticmethod
    def jacobian_from_dict(dic):
        """Jacobian tensor dict: sum of ``dic`` over all swaps of axis 1
        with each trailing axis (generalizes to rank > 3)."""
        rank = max(len(k) for k in dic.keys())
        jac = dict(dic)
        for ax in range(2, rank):
            for idx, v in dic.items():
                swapped = list(idx)
                swapped[1], swapped[ax] = swapped[ax], swapped[1]
                key = tuple(swapped)
                jac[key] = jac.get(key, 0) + v
        return jac

    @staticmethod
    def simplify_dict(dic):
        """Upper-triangularize the trailing indices of a tensor dict
        (entries with permuted trailing indices are accumulated onto the
        sorted-index representative)."""
        out = {}
        for idx, v in dic.items():
            key = tuple([idx[0]] + sorted(idx[1:]))
            out[key] = out.get(key, 0) + v
        return out

    def sub_tensor(self, dic=None, continuation_variables=None):
        """Substitute all parameters except the continuation variables.

        Parameters
        ----------
        dic: dict, optional
            Tensor dict to substitute (default: :attr:`tensor_dict`).
        continuation_variables: list(Parameter/ParametersArray), optional
            Variables left free (their symbols are not substituted).
        """
        if dic is None:
            dic = self.tensor_dict
        subs = collect_parameter_substitutions(self.params)
        if continuation_variables:
            for cv in continuation_variables:
                if isinstance(cv, ParametersArray):
                    for v in cv:
                        subs.pop(getattr(v, 'symbol', None), None)
                else:
                    subs.pop(getattr(cv, 'symbol', None), None)
        out = {}
        for idx, expr in dic.items():
            e = sympy.sympify(expr)
            if e.free_symbols:
                e = e.subs(subs)
            out[idx] = e
        return out


class SymbolicQgsTensorDynamicT(QgsTensorDynamicT, SymbolicQgsTensor):
    """Rank-5 symbolic tensor with dynamical 0-th order temperature."""

    _symbolic = True

    def __init__(self, params=None, atmospheric_inner_products=None,
                 oceanic_inner_products=None, ground_inner_products=None):
        self.tensor_dict = None
        self.jac_dic = None
        QgsTensorDynamicT.__init__(self, params, atmospheric_inner_products,
                                   oceanic_inner_products, ground_inner_products)

    def _quartic_dict(self):
        """Quartic rank-5 entries as a dict (contraction of the symbolic
        rank-5 inner products with the symbolic radiation parameters)."""
        par = self.params
        aips = self.atmospheric_inner_products
        bips = self.oceanic_inner_products or self.ground_inner_products
        ocean = self.oceanic_inner_products is not None
        ground_temp = self.ground_inner_products is not None
        _, a_theta, U_inv, _ = self._mass_matrices()

        out = {}

        def ip5_items(arr5):
            """Iterate (index-tuple, expr) of a SymPy NDim/COO rank-5 store."""
            from qgs_tpu_torch.utils.sparse import COO
            if arr5 is None:
                return
            if isinstance(arr5, COO):
                for e in range(arr5.nnz):
                    yield tuple(int(c) for c in arr5.coords[:, e]), arr5.data[e]
            else:
                arr = np.array(arr5.tolist(), dtype=object)
                for idx in zip(*np.nonzero(arr != 0)):
                    yield idx, arr[idx]

        def contract_scatter(mat, arr5, row_map, col_shift, factor):
            if arr5 is None:
                return
            for (m, j, k, l, mm), val in ip5_items(arr5):
                for i in range(mat.shape[0]):
                    w = mat[i, m]
                    if w == 0:
                        continue
                    key = (row_map(i), j + col_shift, k + col_shift,
                           l + col_shift, mm + col_shift)
                    out[key] = out.get(key, 0) + factor * w * val

        if par.T4LSBpa is not None and aips._z is not None:
            contract_scatter(a_theta, aips._z, self._theta_a, self._theta_a(0),
                             self._p(par.T4LSBpa))
        if ocean and par.T4LSBpgo is not None and aips._v is not None:
            contract_scatter(a_theta, aips._v, self._theta_a, self._deltaT_o(0),
                             -self._p(par.T4LSBpgo))
        if ground_temp and par.T4LSBpgo is not None and aips._v is not None:
            contract_scatter(a_theta, aips._v, self._theta_a, self._deltaT_g(0),
                             -self._p(par.T4LSBpgo))
        if ocean:
            if bips._Z is not None:
                contract_scatter(U_inv, bips._Z, self._deltaT_o, self._theta_a(0),
                                 self._p(par.T4sbpa))
            if bips._V is not None:
                contract_scatter(U_inv, bips._V, self._deltaT_o, self._deltaT_o(0),
                                 -self._p(par.T4sbpgo))
        if ground_temp:
            if bips._Z is not None:
                contract_scatter(U_inv, bips._Z, self._deltaT_g, self._theta_a(0),
                                 self._p(par.T4sbpa))
            if bips._V is not None:
                contract_scatter(U_inv, bips._V, self._deltaT_g, self._deltaT_g(0),
                                 -self._p(par.T4sbpgo))
        return out

    def compute_tensor(self):
        dense3 = QgsTensor._assemble_dense(self)
        d3 = SymbolicQgsTensor._to_dict(dense3)
        full = {idx + (0, 0): v for idx, v in d3.items()}
        for idx, v in self._quartic_dict().items():
            full[idx] = full.get(idx, 0) + v
        self.tensor_dict = {k: v for k, v in full.items() if sympy.sympify(v) != 0}
        self.jac_dic = SymbolicQgsTensor._jacobian_dict(self.tensor_dict, rank=5)
        self.tensor = None
        self.jacobian_tensor = None


class SymbolicQgsTensorT4(SymbolicQgsTensorDynamicT):
    """Rank-5 symbolic tensor with the full quartic T^4 scheme (same
    machinery; the inner products carry the full quartic simplex)."""
