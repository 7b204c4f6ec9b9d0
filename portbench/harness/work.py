"""Operations and bytes that a run needs, and the card's peaks.

Copied from the port's smoke script (``chip_smoke.py``: ``entry_ops``,
``rk4_work``, ``bound``), so that the yardstick stays fixed while the
program changes; the records written and the tangent-linear window are
this file's own.  Counts are of what the inputs need, once: an operation
a kernel repeats, or a byte it reads again, is not counted twice."""

from __future__ import annotations

import numpy as np

# one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense rates):
# vector float64 (the kernels' sparse gathers cannot use the tensor cores),
# the card's highest float64 rate (its tensor cores), vector float32, and
# the device memory's rate
PEAK_F64_VECTOR = 34e12
PEAK_F64 = 67e12
PEAK_F32_VECTOR = 67e12
PEAK_BYTES = 3.35e12


def entry_ops(coords, costs):
    """Operations of one tendency evaluation of the COO tensor ``coords``
    (output row 0, the dummy, dropped), and its entry count.  Since
    ``xx[0] = 1``, an entry costs ``costs[z]``, z the number of its
    trailing indices that are 0: for rank 3 a quadratic term, a linear one
    (no product by the 1) or a constant one."""
    coords = np.asarray(coords)
    keep = coords[0] != 0
    zeros = (coords[1:, keep] == 0).sum(axis=0)
    return int(np.asarray(costs)[zeros].sum()), int(keep.sum())


def rk4_ops(n, coords):
    """Operations of one classical RK4 step of one trajectory: four
    tendency evaluations (an entry costs one product a trailing index that
    is not 0 and one add: 3, 2 or 1 at rank 3) and the combine, 14
    operations a variable."""
    rank = len(coords)
    ops, _ = entry_ops(coords, range(rank, 0, -1))
    return 4 * ops + 14 * n


def rk4_work(B, n, coords, steps, itemsize, records=0):
    """Operations and device-memory bytes of ``steps`` RK4 steps of B
    trajectories: bytes the state read and written, the step sizes, the
    tensor (index and value) each once, and ``records`` recorded states of
    every trajectory written once."""
    rank = len(coords)
    _, nnz = entry_ops(coords, range(rank, 0, -1))
    flops = B * steps * rk4_ops(n, coords)
    n_bytes = (2 * itemsize * B * n + 8 * steps
               + nnz * (4 * (rank - 1) + itemsize)
               + itemsize * B * n * records)
    return flops, n_bytes


def bound_s(flops, n_bytes, peak_flops):
    """The least time in seconds the card could take for ``flops``
    operations at ``peak_flops`` and ``n_bytes`` of device-memory traffic,
    and which of the two bounds it."""
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def jacobian_terms(coords):
    """The rank-3 tensor's Jacobian, ``J_il = d f_i / d x_l``: the number
    of its terms whose coefficient varies with the state (one product and
    one add each a stage; ``T x_j^2`` gives one, ``T x_j x_k`` two), and the
    number of its nonzero entries (i, l)."""
    c = np.asarray(coords)
    i, j, k = c[:, c[0] != 0]
    quad = (j != 0) & (k != 0)
    varying = int(quad.sum() + (quad & (j != k)).sum())
    pairs = np.concatenate([np.stack([i[j != 0], j[j != 0]]),
                            np.stack([i[k != 0], k[k != 0]])], axis=1)
    return varying, int(np.unique(pairs, axis=1).shape[1])


def householder_qr_ops(n, k):
    """Operations of the Householder QR of an n x k matrix (n >= k), Q
    formed explicitly: 2nk^2 - 2k^3/3 for R and as many for Q."""
    return int(round(4 * n * k * k - 4 * k ** 3 / 3))


def tgls_window_ops(n, coords, n_vec, n_sub):
    """Operations of one Benettin window of one trajectory: ``n_sub`` RK4
    substeps of the state (as :func:`rk4_ops`) and of its n x n_vec tangent
    block (each stage the Jacobian's varying terms, 2 operations each, and
    its product with the block, 2 a nonzero entry a column; the combine 14
    an element), then the block's Householder QR and the log of |R_ii| /
    dt, 2 operations a column."""
    varying, nnz_j = jacobian_terms(coords)
    tangent = 4 * (2 * varying + 2 * nnz_j * n_vec) + 14 * n * n_vec
    return (n_sub * (rk4_ops(n, coords) + tangent)
            + householder_qr_ops(n, n_vec) + 2 * n_vec)
