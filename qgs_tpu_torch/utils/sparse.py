"""
Minimal COO sparse-tensor container
===================================

Host-side coordinate-format sparse tensors used to carry the precomputed
tendency tensors from the (NumPy) setup pipeline to the (PyTorch) compute path.
Replaces the reference's dependency on the ``sparse`` package
(ref ``qgs/tensors/qgtensor.py:49-53``) with a small,
self-contained implementation: the device kernels only need
``(coords, data, shape)`` plus densify / transpose-sum / triangularization
helpers.
"""

from __future__ import annotations

import numpy as np


class COO:
    """Coordinate-format sparse tensor: ``coords`` (rank, nnz) int array,
    ``data`` (nnz,) float array, ``shape`` tuple.  Duplicate coordinates are
    summed on construction (canonical form, sorted lexicographically)."""

    def __init__(self, coords, data, shape, sum_duplicates=True):
        coords = np.asarray(coords, dtype=np.int64)
        data = np.asarray(data, dtype=np.float64)
        if coords.ndim == 1:
            coords = coords.reshape(1, -1)
        self.shape = tuple(int(s) for s in shape)
        if sum_duplicates and data.size:
            flat = np.ravel_multi_index(tuple(coords), self.shape)
            order = np.argsort(flat, kind='stable')
            flat, data = flat[order], data[order]
            uniq, start = np.unique(flat, return_index=True)
            summed = np.add.reduceat(data, start) if len(start) else data
            mask = summed != 0.0
            uniq, summed = uniq[mask], summed[mask]
            coords = np.stack(np.unravel_index(uniq, self.shape))
            data = summed
        self.coords = coords
        self.data = data

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_dense(cls, arr):
        arr = np.asarray(arr, dtype=np.float64)
        coords = np.stack(np.nonzero(arr))
        return cls(coords, arr[tuple(coords)], arr.shape, sum_duplicates=False)

    @classmethod
    def from_dict(cls, dic, shape):
        """Build from ``{(i, j, ...): value}``."""
        if not dic:
            return cls(np.zeros((len(shape), 0), dtype=np.int64),
                       np.zeros(0), shape, sum_duplicates=False)
        coords = np.array(list(dic.keys()), dtype=np.int64).T
        data = np.array(list(dic.values()), dtype=np.float64)
        return cls(coords, data, shape)

    @classmethod
    def empty(cls, shape):
        return cls(np.zeros((len(shape), 0), dtype=np.int64), np.zeros(0), shape,
                   sum_duplicates=False)

    # -- basic API ---------------------------------------------------------
    @property
    def nnz(self):
        return self.data.size

    @property
    def rank(self):
        return len(self.shape)

    def todense(self):
        out = np.zeros(self.shape, dtype=np.float64)
        np.add.at(out, tuple(self.coords), self.data)
        return out

    def __add__(self, other):
        if isinstance(other, COO):
            assert self.shape == other.shape
            return COO(np.concatenate([self.coords, other.coords], axis=1),
                       np.concatenate([self.data, other.data]), self.shape)
        raise TypeError(type(other))

    def __mul__(self, scalar):
        return COO(self.coords, self.data * float(scalar), self.shape, sum_duplicates=False)

    __rmul__ = __mul__

    def swapaxes(self, ax1, ax2):
        coords = self.coords.copy()
        coords[[ax1, ax2]] = coords[[ax2, ax1]]
        return COO(coords, self.data.copy(), self.shape)

    def shift(self, offsets):
        """Shift coordinates by per-axis ``offsets`` (broadcastable)."""
        off = np.asarray(offsets, dtype=np.int64).reshape(-1, 1)
        return COO(self.coords + off, self.data.copy(), self.shape, sum_duplicates=False)

    def upper_triangularize_trailing(self):
        """Sort each entry's trailing (non-leading) indices ascending — merges
        symmetric duplicates of a contraction tensor (the contraction
        ``T . x . x ...`` is invariant under this) (ref ``qgtensor.py:724-746``)."""
        coords = self.coords.copy()
        coords[1:, :] = np.sort(coords[1:, :], axis=0)
        return COO(coords, self.data.copy(), self.shape)

    def __repr__(self):
        return f"COO(shape={self.shape}, nnz={self.nnz})"
