"""Plain reference in extended precision, for the cells whose program
computes in a tier near float64 (the double-float ``twofloat`` tier, about
48 bits of mantissa), where a float64 reference's own rounding would be a
share of the gap it reads.

The quadratic tendency ``f_i(x) = sum_jk T_ijk xx_j xx_k`` (``xx = [1,
x]``) over a frozen tensor and classical RK4 on qgs's grid, in NumPy's
``longdouble``: the x87 80-bit format on x86-64 (64 bits of mantissa,
eleven more than float64), IEEE quadruple precision on some other hosts.
The states start from the float64 initial conditions and the steps are
the float64 grid's, both exact in it.  It imports nothing of the port and
uses none of its layouts, kernels or double-float operations."""

from __future__ import annotations

import numpy as np

from portbench.reference import qg

EXTENDED = np.longdouble


def check_extended():
    """Raise where ``longdouble`` is no wider than float64."""
    if np.finfo(EXTENDED).nmant <= np.finfo(np.float64).nmant:
        raise RuntimeError("numpy's longdouble is no wider than float64 on "
                           "this host: no extended-precision reference")


class Quadratic:
    """The tendency of a rank-3 COO tensor in ``longdouble``, for states
    (B, n): each row's entries summed in the order of the tensor."""

    def __init__(self, tensor):
        check_extended()
        keep = tensor.coords[0] != 0
        c, v = tensor.coords[:, keep], tensor.data[keep]
        order = np.argsort(c[0], kind="stable")
        self.i, self.j, self.k = c[0][order] - 1, c[1][order], c[2][order]
        self.v = v[order].astype(EXTENDED)
        self.n = int(tensor.shape[0]) - 1
        self.starts = np.flatnonzero(np.r_[True, np.diff(self.i) != 0])
        self.rows = self.i[self.starts]

    def __call__(self, x):
        xx = np.concatenate([np.ones((x.shape[0], 1), EXTENDED), x], axis=1)
        prod = self.v * xx[:, self.j] * xx[:, self.k]
        out = np.zeros_like(x)
        out[:, self.rows] = np.add.reduceat(prod, self.starts, axis=1)
        return out


def integrate(tendency, ic, t0, t1, dt, write_steps):
    """Classical RK4 of ``ic`` (B, n) over qgs's grid from ``t0`` to
    ``t1`` in ``longdouble``, recording every ``write_steps``-th state and
    the last: (B, n, n_records) in ``longdouble``."""
    dts = np.diff(qg.time_grid(t0, t1, dt))
    keep = set(qg.record_index(len(dts) + 1, write_steps))
    y = np.asarray(ic, dtype=np.float64).astype(EXTENDED)
    recs = [y] if 0 in keep else []
    for s, h in enumerate(dts, 1):
        h = EXTENDED(h)
        k1 = tendency(y)
        k2 = tendency(y + h / 2 * k1)
        k3 = tendency(y + h / 2 * k2)
        k4 = tendency(y + h * k3)
        y = y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        if s in keep:
            recs.append(y)
    return np.stack(recs, axis=-1)
