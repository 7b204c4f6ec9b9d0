"""
Model-axis (row-sharded) tendency evaluation
============================================

Counterpart of :mod:`qgs_tpu.parallel.sharded_tendency`: the tendency's
output rows are dealt across a mesh's ``'model'`` axis and the batch
across its ``'ensemble'`` axis, the data x tensor parallelism of the JAX
package.  Each model entry evaluates only its own whole rows, so no
reduction crosses devices: the row blocks are gathered once (within one
process, a copy onto the ensemble entry's device) and put back in row
order.  There is no psum.

    state   (B, n)        split over 'ensemble', whole on each model entry
    shard m (B_e, W)      the rows dealt to model entry m, W = ceil(rows / n_model)
    output  (B, n)        the gathered blocks, reassembled by a permutation
"""

from __future__ import annotations

import numpy as np
import torch

from qgs_tpu_torch.ops.contraction import (_GatherContraction, _with_dummy,
                                           padded_layout, with_zero)
from qgs_tpu_torch.parallel.mesh import MODEL_AXIS, pad_batch


def make_sharded_tendency(tensor, mesh, dtype=None, overlap_chunks=1,
                          kernel="auto"):
    """A batched tendency ``f(t, x)``: (B, n) -> (B, n), of the COO tensor
    ``tensor`` (the port's ``QgsTensor.tensor``), its rows dealt over the
    mesh's ``'model'`` axis and the batch split over its ``'ensemble'``
    axis (:func:`make_bucketed_sharded_tendency`).  ``x`` is this
    process's block of the ensemble, on any device; the result is on
    ``x``'s device, in ``dtype`` (default float64).

    ``kernel='auto'`` and ``'bucketed'`` run the row-sharded contraction.
    ``'dense'``, the JAX package's comparison path (a reduction-sharded
    matmul with one psum an evaluation), is accepted for API parity and
    runs the same row path, as the port's contraction runs one path for
    every ``mode=`` name.  ``overlap_chunks`` (the chunking of that psum)
    has no effect: it is checked as the JAX package checks it (1 with the
    row kernels; with ``'dense'`` it must divide the per-device batch, at
    the call) and the batch is not chunked."""
    if kernel in ("auto", "bucketed"):
        if overlap_chunks != 1:
            raise ValueError(
                "overlap_chunks applies to the dense kernel only (the "
                "bucketed row-partitioned kernel has no psum to overlap) "
                "— pass kernel='dense' to use it")
        return make_bucketed_sharded_tendency(tensor, mesh, dtype=dtype)
    if kernel != "dense":
        raise ValueError(f"unknown sharded kernel {kernel!r}: expected "
                         "'auto', 'bucketed' or 'dense'")
    return _row_sharded(tensor, mesh, dtype, overlap_chunks)


def make_bucketed_sharded_tendency(tensor, mesh, dtype=None):
    """The row-sharded tendency of :func:`make_sharded_tendency`.

    Whole output rows go to the model entries, sorted by their entry
    count and dealt round-robin, so that each entry holds an equal share
    (+-1) of every count.  Each entry's rows are a contraction on the
    port's padded layout (:func:`~qgs_tpu_torch.ops.contraction.padded_layout`);
    at rank 3 each of them is padded to the whole tensor's longest row, so
    that every row sums the same slots in the same order as the unsharded
    :class:`~qgs_tpu_torch.ops.contraction.Tendency`.  The JAX package's
    count-bucket ladder and pair factoring (``factor_pairs``,
    ``max_buckets``) are not ported."""
    return _row_sharded(tensor, mesh, dtype, 1)


def _deal_rows(counts, n_model):
    """Each row's model entry and position there, and the block width W:
    the rows with entries sorted by count (then index) and dealt
    round-robin; rows without entries get no entry (-1)."""
    rows = np.flatnonzero(counts)
    dealt = rows[np.lexsort((rows, counts[rows]))]
    owner = np.full(counts.size, -1, np.int64)
    owner[dealt] = np.arange(dealt.size) % n_model
    pos = np.full(counts.size, -1, np.int64)
    for m in range(n_model):
        mine = dealt[owner[dealt] == m]
        pos[mine] = np.arange(mine.size)
    return owner, pos, max(-(-dealt.size // n_model), 1)


def _row_sharded(tensor, mesh, dtype, chunks):
    if MODEL_AXIS not in mesh.shape:
        raise ValueError(f"the mesh has no '{MODEL_AXIS}' axis: build it "
                         "with host_chip_mesh(model_axis_size)")
    dtype = torch.float64 if dtype is None else dtype
    coords = np.asarray(tensor.coords, np.int64)
    data = np.asarray(tensor.data, np.float64)
    shape = tuple(int(s) for s in tensor.shape)
    n, n_model = shape[0] - 1, mesh.shape[MODEL_AXIS]
    keep = coords[0] != 0                 # output row 0 is the dummy
    rows, cols, vals = coords[0][keep] - 1, coords[1:, keep], data[keep]
    counts = np.bincount(rows, minlength=n)
    owner, pos, W = _deal_rows(counts, n_model)
    R = max(int(counts.max(initial=0)), 1)

    layouts = []
    for m in range(n_model):
        sel = owner[rows] == m
        layout = padded_layout(pos[rows[sel]], W, list(cols[:, sel]),
                               vals[sel], len(shape))
        if len(shape) == 3:               # every row over the same R slots
            v, idxs = layout[0], layout[1]
            widen = ((0, 0), (0, R - v.shape[1]))
            layout = (np.pad(v, widen), [np.pad(i, widen) for i in idxs],
                      None, None)
        layouts.append(layout)
    # global row -> column of the gathered (B, n_model * W) block; rows
    # without entries -> the zero column appended after it
    final = np.full(n, n_model * W, np.int64)
    has = owner >= 0
    final[has] = owner[has] * W + pos[has]

    groups = mesh.local_groups()
    shards = {}                     # (model entry, device) -> contraction
    perms = {}
    for group in groups:
        for m, d in enumerate(group):
            if (m, d) not in shards:
                shards[m, d] = _GatherContraction(layouts[m], (W,), dtype, d)
        perms.setdefault(group[0], torch.as_tensor(final, device=group[0]))

    def block(group, xs):
        """The (b, n) tendency of one ensemble entry's rows ``xs``."""
        parts = [shards[m, d].contract(_with_dummy(xs.to(d)))
                 for m, d in enumerate(group)]
        full = torch.cat([p.to(group[0]) for p in parts], dim=1)
        return with_zero(full)[:, perms[group[0]]]

    def f(t, x):
        x = x.to(dtype)
        padded, B = pad_batch(x, len(groups))
        size = padded.shape[0] // len(groups)
        if size % chunks:
            raise ValueError(
                f"overlap_chunks={chunks} must divide the per-device batch "
                f"({size})")
        return torch.cat([
            block(group, padded[e * size:(e + 1) * size].to(group[0]))
            .to(x.device) for e, group in enumerate(groups)])[:B]

    return f
