"""
Symbolic sparse contractions
============================

Dict-based symbolic analogues of the device contraction kernels
(ref ``qgs/functions/symbolic_mul.py:14-186``): contract a
``{(i, j, ...): expr}`` tensor dict with symbolic state vectors.
"""

from __future__ import annotations

import sympy


def symbolic_sparse_mult2(tensor_dict, vec):
    """A_{ij} = sum_k T_{ijk} vec_k."""
    res = {}
    for (i, j, k), val in tensor_dict.items():
        res[(i, j)] = res.get((i, j), 0) + val * vec[k]
    return {k: sympy.simplify(v) if False else v for k, v in res.items() if v != 0}


def symbolic_sparse_mult3(tensor_dict, vec_a, vec_b):
    """v_i = sum_{jk} T_{ijk} a_j b_k."""
    res = {}
    for (i, j, k), val in tensor_dict.items():
        res[i] = res.get(i, 0) + val * vec_a[j] * vec_b[k]
    return {k: v for k, v in res.items() if v != 0}


def symbolic_sparse_mult4(tensor_dict, vec_a, vec_b, vec_c):
    """A_{ij} = sum_{klm} T_{ijklm} a_k b_l c_m."""
    res = {}
    for (i, j, k, l, m), val in tensor_dict.items():
        res[(i, j)] = res.get((i, j), 0) + val * vec_a[k] * vec_b[l] * vec_c[m]
    return {k: v for k, v in res.items() if v != 0}


def symbolic_sparse_mult5(tensor_dict, vec_a, vec_b, vec_c, vec_d):
    """v_i = sum_{jklm} T_{ijklm} a_j b_k c_l d_m."""
    res = {}
    for (i, j, k, l, m), val in tensor_dict.items():
        res[i] = res.get(i, 0) + val * vec_a[j] * vec_b[k] * vec_c[l] * vec_d[m]
    return {k: v for k, v in res.items() if v != 0}


def symbolic_tensordot(mat_row, tensor_dict, rank):
    """Contract a vector of expressions with a tensor dict along axis 0."""
    res = {}
    for idx, val in tensor_dict.items():
        w = mat_row[idx[0]]
        if w == 0:
            continue
        key = idx[1:]
        res[key] = res.get(key, 0) + w * val
    return {k: v for k, v in res.items() if v != 0}
