"""
Atmospheric thermodynamic tendency tensor
=========================================

Variant tensor holding only the thermodynamic part of the atmospheric
temperature tendencies (ref
``qgs/tensors/atmo_thermo_tensor.py:20-622``).  Used to
back out the vertical velocity omega from ``f - f_thermo`` in the
diagnostics layer.
"""

from __future__ import annotations

import numpy as np

from qgs_tpu_torch.utils.sparse import COO
from qgs_tpu_torch.tensors.qgtensor import QgsTensor, QgsTensorDynamicT


class AtmoThermoTensor(QgsTensor):
    """Rank-3 thermodynamic-only tensor (theta_a equations only)."""

    def _mass_matrices(self):
        # the thermodynamic equations are premultiplied by u^-1 only
        aips = self.atmospheric_inner_products
        a_theta = None
        if aips is not None:
            a_theta = np.linalg.inv(np.asarray(aips._u, dtype=np.float64))
        return None, a_theta, None, None

    def _assemble_dense(self):
        par = self.params
        aips = self.atmospheric_inner_products
        if par is None or aips is None:
            return None

        atp = par.atemperature_params
        nvar = par.number_of_variables
        ndim = par.ndim
        o = 1 if par.dynamic_T else 0

        ocean = self.oceanic_inner_products is not None
        ground_temp = self.ground_inner_products is not None

        _, a_theta, _, _ = self._mass_matrices()

        T = np.zeros((ndim + 1, ndim + 1, ndim + 1), dtype=np.float64)

        ia = self._psi_a(np.arange(nvar[0]))
        ith_full = self._theta_a(np.arange(nvar[1]))
        ith = self._theta_a(np.arange(nvar[0]) + o)

        g_full = np.asarray(aips._g, dtype=np.float64)
        u_full = np.asarray(aips._u, dtype=np.float64)

        # constant forcing
        if par.Cpa is not None:
            T[ith_full, 0, 0] += par.Cpa.values
        if atp is not None and atp.hd is not None and atp.thetas is not None:
            T[ith_full, 0, 0] += atp.thetas.values * float(atp.hd)

        # advection of temperature by the barotropic flow
        GT = np.einsum('im,mjk->ijk', a_theta, g_full[:, o:, o:])
        T[np.ix_(ith_full, ia, ith)] -= GT

        # relaxation / radiation terms
        U2 = a_theta @ u_full
        heat = 0.0
        if par.Lpa is not None:
            heat += float(atp.sc) * float(par.Lpa)
        if par.LSBpa is not None:
            heat += float(par.LSBpa)
        if atp is not None and atp.hd is not None:
            heat += float(atp.hd)
        if heat != 0.0:
            T[np.ix_(ith_full, ith_full, [0])] -= U2[:, :, None] * heat

        # forcing from the ocean/ground temperature field
        if (ocean or ground_temp) and par.Lpa is not None:
            s_mat = np.asarray(aips._s, dtype=np.float64)
            S2 = a_theta @ s_mat
            fac = float(par.Lpa) / 2
            if par.LSBpgo is not None:
                fac += float(par.LSBpgo)
            if ocean:
                ido_full = self._deltaT_o(np.arange(nvar[3]))
                T[np.ix_(ith_full, ido_full, [0])] += S2[:, :, None] * fac
            else:
                idg = self._deltaT_g(np.arange(nvar[2]))
                T[np.ix_(ith_full, idg, [0])] += S2[:, :, None] * fac

        return T


class AtmoThermoTensorDynamicT(QgsTensorDynamicT, AtmoThermoTensor):
    """Rank-5 thermodynamic-only tensor with dynamical 0-th order temperature."""

    def _quartic_coos(self):
        par = self.params
        aips = self.atmospheric_inner_products
        ndim = par.ndim
        shape5 = (ndim + 1,) * 5
        _, a_theta, _, _ = self._mass_matrices()

        ocean = self.oceanic_inner_products is not None
        ground_temp = self.ground_inner_products is not None

        out = []

        def contract_scatter(mat, coo5, col_shift, factor):
            if coo5 is None or coo5.nnz == 0:
                return
            m_idx = coo5.coords[0]
            trailing = coo5.coords[1:]
            nrows = mat.shape[0]
            weights = mat[:, m_idx] * coo5.data[None, :]
            rows = np.repeat(self._theta_a(np.arange(nrows)), coo5.nnz)
            trail = np.tile(trailing + col_shift, (1, nrows))
            coords = np.concatenate([rows[None, :], trail], axis=0)
            out.append(COO(coords, factor * weights.ravel(), shape5))

        # radiative loss of the atmosphere (sign flipped vs the full tensor:
        # these are the *thermodynamic* contributions themselves)
        if par.T4LSBpa is not None and aips._z is not None:
            contract_scatter(a_theta, aips._z, self._theta_a(0), -float(par.T4LSBpa))
        if ocean and par.T4LSBpgo is not None and aips._v is not None:
            contract_scatter(a_theta, aips._v, self._deltaT_o(0), float(par.T4LSBpgo))
        if ground_temp and par.T4LSBpgo is not None and aips._v is not None:
            contract_scatter(a_theta, aips._v, self._deltaT_g(0), float(par.T4LSBpgo))
        return out


class AtmoThermoTensorT4(AtmoThermoTensorDynamicT):
    """Rank-5 thermodynamic-only tensor with the full quartic T^4 scheme
    (same structure; the inner products carry the full quartic simplex)."""
