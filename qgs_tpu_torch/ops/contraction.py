"""
Tensor contractions (device compute path)
=========================================

Counterpart of :mod:`qgs_tpu.ops.contraction` for rank-3 tendency tensors:

* tendencies:  f_i  = sum_{jk} T[i,j,k] xx_j xx_k
* Jacobian:    J_im = sum_{k}  JT[i,m,k] xx_k
* tangent:     hom_it = sum_{mk} JT[i,m,k] xx_k dm_mt  (``J dm`` without J)

over the state padded with the dummy constant, ``xx = [1, x]``.

There is one implementation.  The entries of each output row are padded to
a common count R (pad value 0, pad index 0, and ``xx[0] == 1``, so a pad
adds exactly zero); the contraction gathers the state at the (n_out, R)
index tables, multiplies, and sums over the last axis.  The sum order is
fixed by the layout, and no ``index_add_`` atomics run on CUDA.  The JAX
package's other ``mode=`` names are accepted for API parity and all run
this path.

Rank-5 (T4 / dynamic-T) tensors are not ported yet (ROADMAP queue 1,
item 8).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

MODES = ("auto", "bucketed", "dense", "coo", "rowsum", "rowsum_fm", "pairsum")


def _check_rank3(shape):
    if len(shape) != 3:
        raise NotImplementedError(
            f"rank-{len(shape)} tendency tensors (T4 / dynamic-T) are not "
            "ported yet: ROADMAP queue 1, item 8")


def row_padded(out_idx, n_out, cols, vals):
    """Pad COO entries to an (n_out, R) layout, R the largest row count.

    ``out_idx`` (nnz,) gives each entry's output row, ``cols`` a list of
    (nnz,) gather-index arrays, ``vals`` (nnz,) the values.  Entries keep
    their COO order within a row.  Returns ``(vals (n_out, R) float64,
    [idx (n_out, R) int64, ...])`` with pads of value 0 and index 0."""
    out_idx = np.asarray(out_idx, np.int64)
    counts = np.bincount(out_idx, minlength=n_out)
    R = max(int(counts.max()) if counts.size else 0, 1)
    order = np.argsort(out_idx, kind="stable")
    rows = out_idx[order]
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.arange(rows.size) - starts[rows]
    v = np.zeros((n_out, R))
    v[rows, slot] = np.asarray(vals, np.float64)[order]
    idxs = []
    for c in cols:
        a = np.zeros((n_out, R), np.int64)
        a[rows, slot] = np.asarray(c, np.int64)[order]
        idxs.append(a)
    return v, idxs


def _with_dummy(x):
    """Prepend the dummy constant 1 along the last axis."""
    return torch.cat([torch.ones_like(x[..., :1]), x], dim=-1)


class _RowPaddedContraction(nn.Module):
    """``prod_a xx[idx_a] * vals`` summed over the padded slot axis."""

    def __init__(self, vals, idxs, out_shape, dtype, device):
        super().__init__()
        self.register_buffer("vals", torch.as_tensor(vals, dtype=dtype,
                                                     device=device))
        for a, idx in enumerate(idxs):
            self.register_buffer(f"idx{a}", torch.as_tensor(idx,
                                                            device=device))
        self.n_idx = len(idxs)
        self.out_shape = tuple(out_shape)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def forward(self, t, x):
        """``x``: (B, n) -> (B, *out_shape).  ``t`` is unused (the model is
        autonomous); it is kept for the ``f(t, x)`` calling convention."""
        xx = _with_dummy(x)
        prod = self.vals
        for a in range(self.n_idx):
            prod = prod * xx[:, getattr(self, f"idx{a}")]
        return prod.sum(dim=-1).reshape((x.shape[0],) + self.out_shape)


class Tendency(_RowPaddedContraction):
    """Batched tendency ``f(t, x)``: (B, n) -> (B, n) of a rank-3 tensor
    given as COO arrays ``coords`` (3, nnz), ``data`` (nnz,) and ``shape``
    (n1, n1, n1).  The host arrays stay on the module (``coords``, ``data``,
    ``shape``) for the fused RK4 kernel to build its own layout from."""

    def __init__(self, coords, data, shape, dtype=torch.float64,
                 device="cuda"):
        _check_rank3(shape)
        coords = np.asarray(coords, np.int64)
        data = np.asarray(data, np.float64)
        n = int(shape[0]) - 1
        keep = coords[0] != 0            # output row 0 is the dummy: dropped
        vals, idxs = row_padded(coords[0][keep] - 1, n,
                                [coords[1][keep], coords[2][keep]],
                                data[keep])
        super().__init__(vals, idxs, (n,), dtype, device)
        self.coords, self.data = coords, data
        self.shape = tuple(int(s) for s in shape)


class Jacobian(_RowPaddedContraction):
    """Batched Jacobian ``Df(t, x)``: (B, n) -> (B, n, n) of a rank-3
    Jacobian tensor, ``J[b, i, m] = sum_e val_e * xx[b, coords[2, e]]`` at
    ``(i, m) = (coords[0, e], coords[1, e])`` (the JAX package's
    ``make_coo_jacobian`` convention)."""

    def __init__(self, coords, data, shape, dtype=torch.float64,
                 device="cuda"):
        _check_rank3(shape)
        coords = np.asarray(coords, np.int64)
        data = np.asarray(data, np.float64)
        n = int(shape[0]) - 1
        keep = (coords[0] != 0) & (coords[1] != 0)
        flat = (coords[0][keep] - 1) * n + (coords[1][keep] - 1)
        vals, idxs = row_padded(flat, n * n, [coords[2][keep]], data[keep])
        super().__init__(vals, idxs, (n, n), dtype, device)


def tangent_layout(coords, data, shape, adjoint=False, inverse=False):
    """The row-padded layout of a direct tangent contraction of a rank-3
    Jacobian tensor: ``(vals (n, R), idx_m (n, R), idx_k (n, R))``, entry
    ``e`` at output row ``coords[0, e] - 1`` gathering tangent row ``m =
    coords[1, e] - 1`` and state ``xx[coords[2, e]]``.  ``adjoint`` swaps
    ``coords[0]`` and ``coords[1]`` and ``inverse`` negates the values, both
    on the host; entries that touch the dummy row or column are dropped
    (its tangent is identically zero)."""
    _check_rank3(shape)
    coords = [np.asarray(c, np.int64) for c in coords]
    data = np.asarray(data, np.float64)
    if inverse:
        data = -data
    if adjoint:
        coords[0], coords[1] = coords[1], coords[0]
    keep = (coords[0] != 0) & (coords[1] != 0)
    vals, (idx_m, idx_k) = row_padded(coords[0][keep] - 1, int(shape[0]) - 1,
                                      [coords[1][keep] - 1, coords[2][keep]],
                                      data[keep])
    return vals, idx_m, idx_k


class Tangent(nn.Module):
    """Direct tangent-linear contraction ``hom(xx, dm) -> (B, n, n_tg)``::

        hom[b, i, t] = sum_e v_e * xx[b, k_e] * dm[b, m_e - 1, t]

    of a rank-3 Jacobian tensor given as COO arrays ``coords`` (3, nnz),
    ``data`` (nnz,) and ``shape`` (n1, n1, n1), over the dummy-padded state
    ``xx`` (B, n1) and a tangent block ``dm`` (B, n, n_tg) without the dummy
    row.  It is ``J(x) dm`` (``J^T dm`` for ``adjoint``, negated for
    ``inverse``) without materializing J, on :func:`tangent_layout`: each
    slot gathers the state at ``k`` and the tangent row at ``m``, and the
    slots of an output row are summed.  The counterpart of the JAX
    package's ``make_direct_tangent`` and ``make_bucketed_tangent``."""

    def __init__(self, coords, data, shape, dtype=torch.float64,
                 adjoint=False, inverse=False, device="cuda"):
        super().__init__()
        vals, idx_m, idx_k = tangent_layout(coords, data, shape, adjoint,
                                            inverse)
        self.register_buffer("vals", torch.as_tensor(vals, dtype=dtype,
                                                     device=device))
        self.register_buffer("idx_m", torch.as_tensor(idx_m, device=device))
        self.register_buffer("idx_k", torch.as_tensor(idx_k, device=device))

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def forward(self, xx, dm):
        coef = self.vals * xx[:, self.idx_k]                     # (B, n, R)
        return (coef[..., None] * dm[:, self.idx_m]).sum(dim=2)


def make_direct_tangent(jtensor, dtype=torch.float64, adjoint=False,
                        inverse=False, device="cuda"):
    """:class:`Tangent` of a COO Jacobian tensor
    (``QgsTensor.jacobian_tensor``)."""
    return Tangent(jtensor.coords, jtensor.data, jtensor.shape, dtype,
                   adjoint, inverse, device)


make_bucketed_tangent = make_direct_tangent


def from_numpy(coords, data, shape, dtype=torch.float64, device="cuda"):
    """Build the batched tendency module from plain COO arrays (the JAX
    package's ``QgsTensor.tensor.coords/.data/.shape``): the port's
    counterpart of loading weights."""
    return Tendency(coords, data, shape, dtype=dtype, device=device)


def make_tendency_fns(tensor, jtensor, mode="auto", dtype=torch.float64,
                      device="cuda"):
    """Build ``(f_batch, jac_batch)`` from a tendency tensor and its
    Jacobian tensor (COO objects, rank 3), as :class:`torch.nn.Module` s:

    * ``f_batch(t, x)``: (B, ndim) -> (B, ndim)
    * ``jac_batch(t, x)``: (B, ndim) -> (B, ndim, ndim)

    ``mode`` accepts the JAX package's names; all run the one row-padded
    gather path."""
    if mode not in MODES:
        raise ValueError(f"unknown contraction mode {mode!r}: expected one "
                         f"of {', '.join(MODES)}")
    f = Tendency(tensor.coords, tensor.data, tensor.shape, dtype, device)
    jac = Jacobian(jtensor.coords, jtensor.data, jtensor.shape, dtype, device)
    return f, jac


class SingleState(nn.Module):
    """A batched function wrapped for single states (reference API shape):
    ``f(t, x)``: (n,) -> (n,).  The batched function is ``.batched``."""

    def __init__(self, batched):
        super().__init__()
        self.batched = batched

    def forward(self, t, x):
        return self.batched(t, x[None, :])[0]


def single_state(f_batch):
    """Wrap a batched function into a single-state one."""
    return SingleState(f_batch)
