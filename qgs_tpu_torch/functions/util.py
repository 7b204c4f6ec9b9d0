"""
Numeric utility functions
=========================

API-parity helpers (ref ``qgs/functions/util.py:14-98``).
The Lyapunov toolbox uses batched torch operations on the device instead,
but these NumPy helpers remain available for user code.
"""

from __future__ import annotations

import numpy as np


def add_to_dict(dic, key, value):
    """Accumulate ``value`` into ``dic[key]``."""
    if key in dic:
        dic[key] = dic[key] + value
    else:
        dic[key] = value


def reverse(a):
    """Reverse a 1-D array."""
    return np.asarray(a)[::-1].copy()


def normalize_matrix_columns(a):
    """Normalize the columns of a matrix; returns (normalized, norms)."""
    a = np.asarray(a)
    norms = np.linalg.norm(a, axis=0)
    return a / norms[None, :], norms


def solve_triangular_matrix(a, b):
    """Solve the upper-triangular system ``a x = b`` by back-substitution."""
    import scipy.linalg

    return scipy.linalg.solve_triangular(a, b, lower=False)
