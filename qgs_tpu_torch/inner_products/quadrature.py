"""
Vectorized quadrature engine for symbolic bases
===============================================

Tensor-product Gauss-Legendre quadrature over the model domain, used to
compute inner products of arbitrary symbolic bases numerically.  All basis
functions (and the derivative fields the coefficient algebra needs) are
evaluated on the grid **once**; every coefficient family then reduces to
one weighted ``einsum`` — replacing the reference's one-process-per-integral
``scipy.dblquad`` fan-out (ref ``qgs/inner_products/symbolic.py:1585-1697``)
with dense contractions.

Gauss-Legendre is spectrally accurate for the trigonometric integrands of
Fourier bases: with ~2 points per half-wave plus margin the results are
exact to machine precision (validated against the analytic closed forms in
the test suite).
"""

from __future__ import annotations

import numpy as np
from sympy import symbols, lambdify, diff, sin, cos

_x, _y = symbols('x y')


def _max_freqs(exprs):
    """Estimate the maximum |d(arg)/dx| and |d(arg)/dy| over all trig atoms
    of the (substituted, numeric-coefficient) expressions."""
    fx = fy = 1.0
    for e in exprs:
        for atom in e.atoms(sin, cos):
            arg = atom.args[0]
            try:
                fx = max(fx, abs(float(diff(arg, _x))))
            except TypeError:
                pass
            try:
                fy = max(fy, abs(float(diff(arg, _y))))
            except TypeError:
                pass
    return fx, fy


class DomainQuadrature:
    """Gauss-Legendre grid on [0, 2 pi/n] x [0, pi] with combined weights
    (including the n/(2 pi^2) normalization or a custom definition's
    normalization/weight)."""

    def __init__(self, n, max_fx=1.0, max_fy=1.0, order=4, oversample=8,
                 normalization=None, weight_expr=None):
        self.n = float(n)
        Lx, Ly = 2 * np.pi / self.n, np.pi
        # points: >= oversample + order * (half-waves across the domain)
        mx = int(np.ceil(order * max_fx * Lx / np.pi + oversample))
        my = int(np.ceil(order * max_fy * Ly / np.pi + oversample))
        gx, wx = np.polynomial.legendre.leggauss(mx)
        gy, wy = np.polynomial.legendre.leggauss(my)
        self.x = (gx + 1) * (Lx / 2)
        self.y = (gy + 1) * (Ly / 2)
        wx = wx * (Lx / 2)
        wy = wy * (Ly / 2)
        self.X, self.Y = np.meshgrid(self.x, self.y, indexing='ij')
        norm = (self.n / (2 * np.pi ** 2)) if normalization is None \
            else normalization(self.n)
        self.W = (np.outer(wx, wy) * norm).ravel()
        if weight_expr is not None:
            wf = lambdify([_x, _y], weight_expr, modules='numpy')
            self.W = self.W * np.broadcast_to(wf(self.X, self.Y), self.X.shape).ravel()
        self.shape = self.X.shape
        self.Xf, self.Yf = self.X.ravel(), self.Y.ravel()

    def evaluate(self, exprs):
        """Evaluate SymPy expressions on the grid -> (n_exprs, n_points)."""
        out = np.empty((len(exprs), self.Xf.size))
        for i, e in enumerate(exprs):
            f = lambdify([_x, _y], e, modules='numpy')
            out[i] = np.broadcast_to(f(self.Xf, self.Yf), self.Xf.shape)
        return out

    # -- grid bundles -------------------------------------------------------

    def field_grids(self, exprs, lap_grad=False):
        """Evaluate a basis and its derivative fields.

        Returns a dict with keys ``F, Fx, Fy, lapF`` and, when ``lap_grad``,
        ``lapFx, lapFy`` (needed for the (S, J(G, lap H)) products)."""
        lap = [diff(e, _x, 2) + diff(e, _y, 2) for e in exprs]
        grids = {
            'F': self.evaluate(exprs),
            'Fx': self.evaluate([diff(e, _x) for e in exprs]),
            'Fy': self.evaluate([diff(e, _y) for e in exprs]),
            'lapF': self.evaluate(lap),
        }
        if lap_grad:
            grids['lapFx'] = self.evaluate([diff(e, _x) for e in lap])
            grids['lapFy'] = self.evaluate([diff(e, _y) for e in lap])
        return grids

    # -- contraction primitives ---------------------------------------------

    def pair(self, A, B):
        """C_ij = int A_i B_j."""
        return (A * self.W[None, :]) @ B.T

    def triple(self, A, B, C, chunk=4096):
        """T_ijk = int A_i B_j C_k (g-chunked to bound memory)."""
        nA, nB, nC = A.shape[0], B.shape[0], C.shape[0]
        out = np.zeros((nA, nB, nC))
        G = A.shape[1]
        for lo in range(0, G, chunk):
            hi = min(lo + chunk, G)
            Aw = A[:, lo:hi] * self.W[None, lo:hi]
            # pairwise matmul path: D_(jk),g then (A W) @ D^T
            D = np.einsum('jg,kg->jkg', B[:, lo:hi], C[:, lo:hi])
            out += np.einsum('ig,jkg->ijk', Aw, D)
        return out

    def jacobian_triple(self, A, Bgrids, Cgrids, Bk='F', Ck='F'):
        """T_ijk = int A_i J(B_j, C_k) with J from the grid derivative
        bundles; ``Bk``/``Ck`` select plain ('F') or Laplacian ('lapF')
        fields for the second Jacobian argument."""
        Bx = Bgrids['Fx'] if Bk == 'F' else Bgrids['lapFx']
        By = Bgrids['Fy'] if Bk == 'F' else Bgrids['lapFy']
        Cx = Cgrids['Fx'] if Ck == 'F' else Cgrids['lapFx']
        Cy = Cgrids['Fy'] if Ck == 'F' else Cgrids['lapFy']
        return self.triple(A, Bx, Cy) - self.triple(A, Cx, By).swapaxes(1, 2)

    def quintic(self, A, B, C, D, E, chunk=512):
        """T_ijklm = int A_i B_j C_k D_l E_m (for the quartic T^4 products).

        Memory-bounded by chunking over grid points; intended for the small
        bases where T^4 is used.
        """
        out = np.zeros((A.shape[0], B.shape[0], C.shape[0], D.shape[0], E.shape[0]))
        G = A.shape[1]
        for lo in range(0, G, chunk):
            hi = min(lo + chunk, G)
            Aw = A[:, lo:hi] * self.W[None, lo:hi]
            out += np.einsum('ig,jg,kg,lg,mg->ijklm', Aw, B[:, lo:hi],
                             C[:, lo:hi], D[:, lo:hi], E[:, lo:hi],
                             optimize=True)
        return out

    def integral(self, expr):
        """Weighted integral of an arbitrary integrand expression."""
        f = lambdify([_x, _y], expr, modules='numpy')
        vals = np.broadcast_to(f(self.Xf, self.Yf), self.Xf.shape)
        return float(np.dot(self.W, vals))


def prune_small(arr, tol=5e-11):
    """Zero out quadrature noise (reference zeroes results below the
    quadrature error estimate, ``symbolic.py:1630``)."""
    arr = np.asarray(arr)
    arr[np.abs(arr) < tol] = 0.0
    return arr
