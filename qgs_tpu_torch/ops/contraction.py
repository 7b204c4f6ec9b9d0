"""
Tensor contractions (device compute path)
=========================================

Counterpart of :mod:`qgs_tpu.ops.contraction` for the tendency tensors of
rank 3 (``QgsTensor``) and rank 5 (``QgsTensorDynamicT``, ``QgsTensorT4``):

* tendencies:  f_i  = sum_e v_e prod_{a>=1} xx[coords[a, e]]
* Jacobian:    J_im = sum_e v_e prod_{a>=2} xx[coords[a, e]],
  ``(i, m) = (coords[0, e], coords[1, e])``
* tangent:     hom_it = sum_m J_im dm_mt  (``J dm``)

over the state padded with the dummy constant, ``xx = [1, x]``.

A module called with tensors returns tensors on its device.  Called with
NumPy states (or any other array-likes), as an external ODE solver calls
``f(t, x)``, it converts them once to its dtype and device and returns
NumPy arrays: the reference's contract, which ``np.asarray`` and
``scipy.integrate.solve_ivp`` consume whatever the device
(:func:`numpy_call`).

There is one implementation, a gather-multiply-sum over a padded layout
(pad value 0, pad index 0, and ``xx[0] == 1``, so a pad adds exactly zero).
The sum order is fixed by the layout, and no ``index_add_`` atomics run on
CUDA.  The JAX package's other ``mode=`` names are accepted for API parity
and all run this path.

* Rank 3 pads every output row to the longest row (:func:`row_padded`).
* Rank 5 rows are far more uneven (the T4 tendency's longest row holds 428
  of 5,331 entries), so its layout is :func:`two_level`: each row's entries
  in chunks of C slots, the chunk sums, then each row's chunk sums, placed
  at the outputs by a static index.  The launch count is fixed whatever the
  spread of the row counts.
* The rank-3 tangent gathers the tangent block slot by slot
  (:func:`tangent_layout`).  The rank-5 tangent contracts the state first:
  its coefficient is the (B, n, n) Jacobian on the two-level layout (with
  the adjoint and inverse transforms applied on the host), then one
  batched matrix product with the tangent block.

Each evaluation of a two-level contraction counts in
:data:`two_level_calls` and, under a profiler, runs inside the span
``qgs.two_level`` (:func:`~qgs_tpu_torch.utils.profiling.span`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from qgs_tpu_torch.utils.profiling import span

MODES = ("auto", "bucketed", "dense", "coo", "rowsum", "rowsum_fm", "pairsum")

SLOT_BOUND = 1.5         # a two-level layout's slots per kept entry, at most,
                         # where a power-of-two chunk width reaches it (both
                         # levels counted: T4's layouts take 1.37-1.41)

two_level_calls = 0      # two-level contractions evaluated in this process


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


class TwoLevelLayout(NamedTuple):
    """The layout of :func:`two_level`: ``vals`` (n_chunks, C) and ``idxs``
    (a list of (n_chunks, C) gather indices), a row's chunks consecutive;
    ``chunks`` (n_rows, K), the chunks of each output row that has entries,
    ``n_chunks`` (a zero column) past its last; ``perm`` (n_out,), each
    output's position among those rows, ``n_rows`` (a zero column) for an
    output without entries."""
    vals: np.ndarray
    idxs: list
    chunks: np.ndarray
    perm: np.ndarray


def _chunk_counts(counts, C):
    """Chunks of each row of ``counts`` entries at width ``C``."""
    return -(-np.asarray(counts, np.int64) // C)


def two_level_slots(counts, C):
    """Slots of a :func:`two_level` layout of rows of ``counts`` entries at
    chunk width ``C``: ``n_chunks * C`` entry slots and ``n_rows * K``
    chunk-sum slots."""
    per_row = _chunk_counts(counts, C)
    K = max(int(per_row.max(initial=0)), 1)
    return int(per_row.sum()) * C + int((per_row > 0).sum()) * K


def chunk_width(counts):
    """The chunk width of a :func:`two_level` layout: the smallest power of
    two whose slots are at most :data:`SLOT_BOUND` times the entries, else
    the power of two with the fewest slots (the first of them on a tie)."""
    counts = np.asarray(counts, np.int64)
    nnz, top = int(counts.sum()), max(int(counts.max(initial=0)), 1)
    widths = [1 << p for p in range(top.bit_length() + 1)]
    slots = [two_level_slots(counts, C) for C in widths]
    for C, s in zip(widths, slots):
        if s <= SLOT_BOUND * nnz:
            return C
    return widths[int(np.argmin(slots))]


def two_level(out_idx, n_out, cols, vals):
    """Lay COO entries out for a two-level fixed-order sum (a
    :class:`TwoLevelLayout`): each output row's entries, in COO order, in
    chunks of :func:`chunk_width` slots, pads of value 0 and index 0.
    Arguments as :func:`row_padded`'s."""
    out_idx = np.asarray(out_idx, np.int64)
    counts = np.bincount(out_idx, minlength=n_out)
    C = chunk_width(counts)
    order = np.argsort(out_idx, kind="stable")
    rows = out_idx[order]
    occ = np.arange(rows.size) - np.concatenate(([0],
                                                 np.cumsum(counts)[:-1]))[rows]
    per_row = _chunk_counts(counts, C)
    first = np.concatenate(([0], np.cumsum(per_row)[:-1]))
    chunk, slot = first[rows] + occ // C, occ % C
    n_chunks = int(per_row.sum())
    v = np.zeros((n_chunks, C))
    v[chunk, slot] = np.asarray(vals, np.float64)[order]
    idxs = []
    for c in cols:
        a = np.zeros((n_chunks, C), np.int64)
        a[chunk, slot] = np.asarray(c, np.int64)[order]
        idxs.append(a)
    full = np.flatnonzero(counts)
    k = np.arange(max(int(per_row.max(initial=0)), 1))
    chunks = np.where(k < per_row[full, None], first[full, None] + k, n_chunks)
    perm = np.full(n_out, full.size, np.int64)
    perm[full] = np.arange(full.size)
    return TwoLevelLayout(v, idxs, chunks, perm)


def padded_layout(out_idx, n_out, cols, vals, rank):
    """The layout of a contraction of a rank-``rank`` tensor: ``(vals,
    idxs, chunks, perm)``, :func:`row_padded` for rank 3 (``chunks`` and
    ``perm`` None), :func:`two_level` otherwise."""
    if rank == 3:
        return (*row_padded(out_idx, n_out, cols, vals), None, None)
    return tuple(two_level(out_idx, n_out, cols, vals))


def _tensors(x, dtype, device):
    """An array-like state, or a tuple of them, as tensors of ``dtype`` on
    ``device``."""
    if isinstance(x, tuple):
        return tuple(_tensors(p, dtype, device) for p in x)
    return torch.as_tensor(x, dtype=dtype, device=device)


def is_tensor_state(*xs):
    """Whether every state of ``xs`` (a tensor, or a tuple of them) is a
    tensor."""
    return all(isinstance(p, torch.Tensor)
               for x in xs for p in (x if isinstance(x, tuple) else (x,)))


def to_numpy(out):
    """A tensor, or a tuple of them, as NumPy arrays on the host."""
    if isinstance(out, tuple):
        return tuple(to_numpy(p) for p in out)
    return out.detach().cpu().numpy()


def numpy_call(fn, xs, dtype, device):
    """``fn(*xs)`` for states given as NumPy arrays (or other array-likes,
    or tuples of them): each converted once to ``dtype`` on ``device``, the
    result returned as NumPy."""
    return to_numpy(fn(*(_tensors(x, dtype, device) for x in xs)))


def _with_dummy(x):
    """Prepend the dummy constant 1 along the last axis."""
    return torch.cat([torch.ones_like(x[..., :1]), x], dim=-1)


def with_zero(p):
    """Append a zero column along the last axis (the target of pads)."""
    return torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)


def _jacobian_entries(coords, data, adjoint=False, inverse=False):
    """The entries of a COO Jacobian tensor that touch neither the dummy
    row nor the dummy column, ``(rows i - 1, columns m - 1, trailing
    coordinates, values)``; ``adjoint`` swaps ``i`` and ``m`` and
    ``inverse`` negates the values."""
    coords = [np.asarray(c, np.int64) for c in coords]
    data = np.asarray(data, np.float64)
    if inverse:
        data = -data
    if adjoint:
        coords[0], coords[1] = coords[1], coords[0]
    keep = (coords[0] != 0) & (coords[1] != 0)
    return (coords[0][keep] - 1, coords[1][keep] - 1,
            [c[keep] for c in coords[2:]], data[keep])


def jacobian_layout(coords, data, shape, adjoint=False, inverse=False):
    """The layout (:func:`padded_layout`) of a Jacobian tensor's
    contraction to (n, n), output ``i * n + m``, gathering each trailing
    coordinate; ``adjoint`` and ``inverse`` as :func:`_jacobian_entries`."""
    n = int(shape[0]) - 1
    rows, cols, trailing, vals = _jacobian_entries(coords, data, adjoint,
                                                   inverse)
    return padded_layout(rows * n + cols, n * n, trailing, vals, len(shape))


class _GatherContraction(nn.Module):
    """``prod_a xx[idx_a] * vals`` summed over the slot axis, and for a
    two-level layout the chunk sums of each row summed and placed at the
    outputs: (B, n1) -> (B, *out_shape)."""

    def __init__(self, layout, out_shape, dtype, device):
        super().__init__()
        vals, idxs, chunks, perm = layout
        self.register_buffer("vals", torch.as_tensor(vals, dtype=dtype,
                                                     device=device))
        for a, idx in enumerate(idxs):
            self.register_buffer(f"idx{a}", torch.as_tensor(idx,
                                                            device=device))
        self.n_idx = len(idxs)
        self.two_level = chunks is not None
        if self.two_level:
            self.register_buffer("chunks", torch.as_tensor(chunks,
                                                           device=device))
            self.register_buffer("perm", torch.as_tensor(perm, device=device))
        self.out_shape = tuple(out_shape)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def contract(self, xx):
        """``xx``: the dummy-padded (B, n1) state."""
        if not self.two_level:
            return self._contract(xx)
        global two_level_calls
        two_level_calls += 1
        with span("qgs.two_level"):
            return self._contract(xx)

    def _contract(self, xx):
        prod = self.vals
        for a in range(self.n_idx):
            prod = prod * xx[:, getattr(self, f"idx{a}")]
        out = prod.sum(dim=-1)
        if self.two_level:
            out = with_zero(with_zero(out)[:, self.chunks].sum(dim=-1))
            out = out[:, self.perm]
        return out.reshape((xx.shape[0],) + self.out_shape)

    def forward(self, t, x):
        """``x``: (B, n) -> (B, *out_shape).  ``t`` is unused (the model is
        autonomous); it is kept for the ``f(t, x)`` calling convention.  A
        ``x`` that is not a tensor gives NumPy (:func:`numpy_call`)."""
        if not isinstance(x, torch.Tensor):
            return numpy_call(lambda x: self.contract(_with_dummy(x)), (x,),
                              self.dtype, self.device)
        return self.contract(_with_dummy(x))


class Tendency(_GatherContraction):
    """Batched tendency ``f(t, x)``: (B, n) -> (B, n) of a tensor of rank 3
    or 5 given as COO arrays ``coords`` (rank, nnz), ``data`` (nnz,) and
    ``shape`` (n1,) * rank.  The host arrays stay on the module
    (``coords``, ``data``, ``shape``) for the fused RK4 kernel (rank 3) to
    build its own layout from."""

    def __init__(self, coords, data, shape, dtype=torch.float64,
                 device="cuda"):
        coords = np.asarray(coords, np.int64)
        data = np.asarray(data, np.float64)
        n = int(shape[0]) - 1
        keep = coords[0] != 0            # output row 0 is the dummy: dropped
        layout = padded_layout(coords[0][keep] - 1, n,
                               [c[keep] for c in coords[1:]], data[keep],
                               len(shape))
        super().__init__(layout, (n,), dtype, device)
        self.coords, self.data = coords, data
        self.shape = tuple(int(s) for s in shape)


class Jacobian(_GatherContraction):
    """Batched Jacobian ``Df(t, x)``: (B, n) -> (B, n, n) of a Jacobian
    tensor of rank 3 or 5, ``J[b, i, m] = sum_e val_e * prod_{a>=2} xx[b,
    coords[a, e]]`` at ``(i, m) = (coords[0, e], coords[1, e])`` (the JAX
    package's ``make_coo_jacobian`` convention)."""

    def __init__(self, coords, data, shape, dtype=torch.float64,
                 device="cuda"):
        n = int(shape[0]) - 1
        super().__init__(jacobian_layout(coords, data, shape), (n, n), dtype,
                         device)


def tangent_layout(coords, data, shape, adjoint=False, inverse=False):
    """The row-padded layout of a direct tangent contraction of a rank-3
    Jacobian tensor: ``(vals (n, R), idx_m (n, R), idx_k (n, R))``, entry
    ``e`` at output row ``coords[0, e] - 1`` gathering tangent row ``m =
    coords[1, e] - 1`` and state ``xx[coords[2, e]]``.  ``adjoint`` swaps
    ``coords[0]`` and ``coords[1]`` and ``inverse`` negates the values, both
    on the host; entries that touch the dummy row or column are dropped
    (its tangent is identically zero)."""
    rows, cols, (k,), vals = _jacobian_entries(coords, data, adjoint,
                                               inverse)
    vals, (idx_m, idx_k) = row_padded(rows, int(shape[0]) - 1, [cols, k],
                                      vals)
    return vals, idx_m, idx_k


class Tangent(nn.Module):
    """Direct tangent-linear contraction ``hom(xx, dm) -> (B, n, n_tg)``::

        hom[b, i, t] = sum_e v_e * prod_{a>=2} xx[b, coords[a, e]]
                           * dm[b, coords[1, e] - 1, t]

    of a Jacobian tensor given as COO arrays ``coords`` (rank, nnz),
    ``data`` (nnz,) and ``shape`` (n1,) * rank, over the dummy-padded state
    ``xx`` (B, n1) and a tangent block ``dm`` (B, n, n_tg) without the
    dummy row.  It is ``J(x) dm`` (``J^T dm`` for ``adjoint``, negated for
    ``inverse``).  Rank 3 does not materialize J: on :func:`tangent_layout`
    each slot gathers the state at ``k`` and the tangent row at ``m``, and
    the slots of an output row are summed.  Rank 5 forms the transformed
    (B, n, n) Jacobian on its two-level layout (``.coef``), then one batched
    product with ``dm``: the (B, n, R, n_tg) gather of the rank-3 route
    would be gigabytes there.  The counterpart of the JAX package's
    ``make_direct_tangent`` and ``make_bucketed_tangent``."""

    def __init__(self, coords, data, shape, dtype=torch.float64,
                 adjoint=False, inverse=False, device="cuda"):
        super().__init__()
        n = int(shape[0]) - 1
        self.coef = None
        if len(shape) != 3:
            self.coef = _GatherContraction(
                jacobian_layout(coords, data, shape, adjoint, inverse),
                (n, n), dtype, device)
            return
        vals, idx_m, idx_k = tangent_layout(coords, data, shape, adjoint,
                                            inverse)
        self.register_buffer("vals", torch.as_tensor(vals, dtype=dtype,
                                                     device=device))
        self.register_buffer("idx_m", torch.as_tensor(idx_m, device=device))
        self.register_buffer("idx_k", torch.as_tensor(idx_k, device=device))

    def _vals(self):
        return self.vals if self.coef is None else self.coef.vals

    @property
    def dtype(self):
        return self._vals().dtype

    @property
    def device(self):
        return self._vals().device

    def forward(self, xx, dm):
        if not is_tensor_state(xx, dm):
            return numpy_call(self.forward, (xx, dm), self.dtype, self.device)
        if self.coef is not None:
            return self.coef.contract(xx) @ dm
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
    Jacobian tensor (COO objects, rank 3 or 5), as :class:`torch.nn.Module`
    s:

    * ``f_batch(t, x)``: (B, ndim) -> (B, ndim)
    * ``jac_batch(t, x)``: (B, ndim) -> (B, ndim, ndim)

    ``mode`` accepts the JAX package's names; all run the one gather path
    (:func:`padded_layout`)."""
    if mode not in MODES:
        raise ValueError(f"unknown contraction mode {mode!r}: expected one "
                         f"of {', '.join(MODES)}")
    f = Tendency(tensor.coords, tensor.data, tensor.shape, dtype, device)
    jac = Jacobian(jtensor.coords, jtensor.data, jtensor.shape, dtype, device)
    return f, jac


class SingleState(nn.Module):
    """A batched function wrapped for single states (reference API shape):
    ``f(t, x)``: (n,) -> (n,).  The batched function is ``.batched``; a
    ``x`` that is not a tensor reaches it as a NumPy array, and so gives
    NumPy."""

    def __init__(self, batched):
        super().__init__()
        self.batched = batched

    def forward(self, t, x):
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        return self.batched(t, x[None, :])[0]


def single_state(f_batch):
    """Wrap a batched function into a single-state one."""
    return SingleState(f_batch)
