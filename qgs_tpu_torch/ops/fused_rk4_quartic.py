"""
Fused rank-5 RK4 kernel (K5)
============================

K5's family (:data:`K5`) for the fused RK4 kernels' one seam
(:class:`~qgs_tpu_torch.ops.fused_rk4.KernelFamily`): classical RK4 steps
of a rank-5 (quartic) tendency, ``f_i = sum_e v_e xx[j] xx[k] xx[l] xx[m]``
over ``xx = [1, y]`` (qgs's dynamic-T and full quartic T4 radiation
schemes), in float32 or float64, in one launch of K1's resident kernel
(``csrc/rk4_fused.cu``) over one of two layouts of the entries.  It
replaces no TPU kernel (the JAX package's Pallas kernels take rank 3
only).

* :func:`fused_rk4_quartic` launches the kernel for a CUDA state and
  counts the launch in :data:`launches` (the paired layout's in
  :data:`launches_paired` too); anything it cannot run raises (the
  integrators take the plain step loop instead).
* :func:`quartic_layout` is the kernel's tensor layout: the output rows
  split into G groups of about equal entry count (K1's
  :func:`~qgs_tpu_torch.ops.fused_rk4.row_groups`), one warp of a block
  each, every group a flat table of entries.  The four-gather layout
  (``"resident"``) packs an entry's four trailing indices in one word
  ``j | k << 8 | l << 16 | m << 24``; the paired layout (``"paired"``)
  pairs each entry's nonzero indices (:func:`paired_indices`), so that an
  entry is K1's two-index record over the extended stage input ``xx' =
  [1, y, p]``, ``p`` the products of the distinct pairs the entries need,
  which the kernel forms once a stage.  :func:`quartic_records` and
  :func:`paired_records` pack them as the kernel's 16-byte records, and
  :func:`quartic_group_tendency` and :func:`paired_group_tendency`
  evaluate the tendency through each in plain PyTorch, in the kernel's
  summation order.  :data:`layout_builds` counts the
  :func:`quartic_layout` calls.
* G is 16 for every tensor (``K5.groups``).  The four-gather layout's
  shared memory is K1's resident formula
  (:func:`~qgs_tpu_torch.ops.fused_rk4.smem_bytes`), the paired one's
  :func:`paired_smem_bytes`.  The launch plan takes the paired layout
  where it fits the card, else the four-gather one where that fits, else
  none (:func:`~qgs_tpu_torch.ops.fused_rk4.pick_kernel` over
  ``K5.kernels``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qgs_tpu_torch.ops.contraction import Tendency, _with_dummy
from qgs_tpu_torch.ops.fused_rk4 import (CHUNK, LANES, LAST, KernelFamily,
                                         _itemsize, csr_rows, fill_groups,
                                         pack_records, row_groups,
                                         run_records, smem_bytes, value_words)

launches = 0             # kernel launches in this process
launches_paired = 0      # those of them over the paired layout
layout_builds = 0        # quartic_layout calls in this process

_FNS = {torch.float32: "qgs_rk4_quartic_f32",
        torch.float64: "qgs_rk4_quartic_f64"}
_PAIRED_FNS = {torch.float32: "qgs_rk4_paired_f32",
               torch.float64: "qgs_rk4_paired_f64"}

MAX_N1 = 256             # an index is one byte of a record's index word


class QuarticLayout(NamedTuple):
    """The kernel's tables of entry records, one row of each per group:
    ``jklm`` (G, W) int32 holding the bits of ``j | k << 8 | l << 16 | m
    << 24``, ``ctl`` (G, W) int32 state row ``i`` (0-based, ``xx`` row
    ``i + 1``) ``| LAST`` on the row's last chunk, ``vals`` (G, W)
    float64; ``lengths`` (G,) int32 records of each group (whole chunks);
    ``group_of_row`` (n,) the group of each state row.  Past each group's
    length the records are zero, at least
    :data:`~qgs_tpu_torch.ops.fused_rk4.AHEAD` chunks of them.  The paired
    layout of the same entries: ``ab`` (G, W) int32 ``a | b << 16`` over
    the extended stage input (:func:`paired_indices`), with the same
    ``ctl``, ``vals`` and ``lengths``, and ``pairs`` (P, 2) int64 the
    pair table, pair ``q`` the product row ``n1 + q``."""
    jklm: np.ndarray
    ctl: np.ndarray
    vals: np.ndarray
    lengths: np.ndarray
    group_of_row: np.ndarray
    ab: np.ndarray
    pairs: np.ndarray


def quartic_csr(coords, data, shape):
    """Row-sorted entries of a rank-5 COO tensor for the kernel.

    Entries of output row 0 (the dummy) are dropped; the others keep their
    COO order within a row.  Returns ``(row_ptr (n1 + 1,) int32, jklm
    (nnz,) int32 holding j | k << 8 | l << 16 | m << 24, vals (nnz,)
    float64)``."""
    if len(shape) != 5:
        raise NotImplementedError("the fused rank-5 RK4 kernel takes rank-5 "
                                  "tensors")
    if int(shape[0]) > MAX_N1:
        raise ValueError(f"n1 = {shape[0]} exceeds the kernel's 8-bit "
                         f"indices (n1 <= {MAX_N1})")
    row_ptr, (j, k, l, m), vals = csr_rows(coords, data, shape)
    jklm = (j | (k << 8) | (l << 16) | (m << 24)).astype(np.uint32)
    return row_ptr, jklm.view(np.int32), vals


def unpack(jklm):
    """The four indices of packed index words, ``(4, ...)`` int64."""
    w = np.asarray(jklm).astype(np.int64) & 0xffffffff
    return np.stack([(w >> (8 * a)) & 0xff for a in range(4)])


def paired_indices(idx, n1):
    """The paired layout's two indices of each entry, from its four
    trailing indices ``idx`` (4, nnz): each entry's nonzero indices,
    sorted; four of them become the products of the first two and of the
    last two, three the lowest and the product of the other two, two or
    fewer the indices themselves (0, ``xx[0] = 1``, for the rest).  A
    product is row ``n1 + q`` of the extended stage input, ``q`` its pair's
    place in the pair table: the distinct pairs, both indices nonzero, in
    increasing order.  Returns ``(pairs (P, 2) int64, a (nnz,) int64,
    b (nnz,) int64)``, the entry's term ``v * xx'[a] * xx'[b]``."""
    s = np.sort(np.asarray(idx, np.int64).reshape(4, -1), axis=0)
    d = (s != 0).sum(axis=0)
    lo, hi = d == 4, d >= 3
    keys = np.concatenate([s[0, lo] * n1 + s[1, lo],
                           s[2, hi] * n1 + s[3, hi]])
    uniq, q = np.unique(keys, return_inverse=True)
    pairs = np.stack([uniq // n1, uniq % n1], axis=1)
    a = np.where(d == 3, s[1], s[2])
    b = s[3].copy()
    a[lo] = n1 + q[:lo.sum()]
    b[hi] = n1 + q[lo.sum():]
    return pairs, a, b


def pair_count(coords, n1):
    """P, the distinct pairs of the paired layout of a rank-5 COO tensor
    (output row 0, the dummy, dropped): a launch plan's count, from the
    indices alone."""
    coords = np.asarray(coords)
    return len(paired_indices(coords[1:, coords[0] != 0], int(n1))[0])


def quartic_layout(coords, data, shape, groups, rows=None):
    """Split the output rows of a rank-5 COO tensor into ``groups`` groups
    for the kernel (a :class:`QuarticLayout`, both layouts), as
    :func:`~qgs_tpu_torch.ops.fused_rk4.row_groups` assigns them
    (``rows``, that assignment where the caller has it); a group lists its
    rows in increasing order, each row's entries in COO order, padded with
    zero entries to its chunks (so that the kernel still writes a row
    without entries; a zero entry gathers ``xx[0] = 1`` and adds 0).
    Counts the call in :data:`layout_builds`."""
    global layout_builds
    layout_builds += 1
    rg = rows if rows is not None else row_groups(coords, shape[0], groups)
    row_ptr, jklm, vals = quartic_csr(coords, data, shape)
    pairs, a, b = paired_indices(unpack(jklm), int(shape[0]))
    ab = (a | (b << 16)).astype(np.int32)
    return QuarticLayout(*fill_groups(row_ptr, jklm, vals, rg),
                         fill_groups(row_ptr, ab, vals, rg)[0], pairs)


def quartic_records(layout, dtype):
    """The kernel's records of ``layout`` with each value in ``dtype``:
    int32 (G, W, 4), record ``[g, e]`` the 16 bytes ``{jklm, ctl, value
    words}`` (:func:`~qgs_tpu_torch.ops.fused_rk4.value_words`)."""
    return pack_records(layout.jklm, layout.ctl,
                        value_words(layout.vals, dtype))


def paired_records(layout, dtype):
    """The paired layout's records: K1's 16 bytes ``{a | b << 16, ctl,
    value words}``, and its pair table as int32 words ``a | b << 16``
    (P,)."""
    words = (layout.pairs[:, 0] | (layout.pairs[:, 1] << 16)).astype(np.int32)
    return (pack_records(layout.ab, layout.ctl,
                         value_words(layout.vals, dtype)), words)


def _chunk_sums(rows_of, prod, x):
    """The group's products ``prod`` (B, length) summed into the rows of
    ``x``'s shape in the kernel's order: slot ``s`` of each chunk of a row
    into partial sum ``s``, the partial sums added at the row's end."""
    parts = [torch.zeros_like(x).index_add_(1, rows_of[s::CHUNK],
                                            prod[:, s::CHUNK])
             for s in range(CHUNK)]
    return sum(parts[1:], parts[0])


def _group_rows_vals(layout, g, length, x):
    rows = torch.as_tensor(layout.ctl[g, :length] & (LAST - 1),
                           device=x.device)
    vals = torch.as_tensor(layout.vals[g, :length], dtype=x.dtype,
                           device=x.device)
    return rows, vals


def quartic_group_tendency(layout, x):
    """The tendency of the (B, n) state ``x`` through ``layout``'s
    four-gather tables, in plain PyTorch and in the kernel's order: group
    by group, each entry's product formed as ``(v * a * b) * (c * d)``,
    slot ``s`` of each chunk of a row summed in order into partial sum
    ``s``, the partial sums added at the row's end."""
    xx = _with_dummy(x)
    out = torch.zeros_like(x)
    for g, length in enumerate(layout.lengths.tolist()):
        a, b, c, d = (torch.as_tensor(i, device=x.device)
                      for i in unpack(layout.jklm[g, :length]))
        rows, vals = _group_rows_vals(layout, g, length, x)
        prod = (vals * xx[:, a] * xx[:, b]) * (xx[:, c] * xx[:, d])
        out += _chunk_sums(rows, prod, x)
    return out


def paired_group_tendency(layout, x):
    """The same through the paired tables, in the paired kernel's order:
    the products ``xx[a_q] * xx[b_q]`` of the pair table first, appended to
    ``xx``, then each entry as ``(v * xx'[a]) * xx'[b]``."""
    xx = _with_dummy(x)
    pa, pb = (torch.as_tensor(c, device=x.device) for c in layout.pairs.T)
    xe = torch.cat([xx, xx[:, pa] * xx[:, pb]], dim=1)
    out = torch.zeros_like(x)
    for g, length in enumerate(layout.lengths.tolist()):
        ab = torch.as_tensor(layout.ab[g, :length].astype(np.int64),
                             device=x.device)
        rows, vals = _group_rows_vals(layout, g, length, x)
        prod = vals * xe[:, ab & 0xffff] * xe[:, ab >> 16]
        out += _chunk_sums(rows, prod, x)
    return out


def paired_smem_bytes(n1, n_pairs, groups, width, dtype):
    """Shared memory of one block of the paired layout in ``dtype``: K1's
    resident formula, each stage input ``n_pairs`` rows longer, and the
    pair table (``paired_smem_bytes`` of ``csrc/rk4_fused.cu``, which
    ``chip_smoke.py`` holds this against)."""
    return (smem_bytes(n1, groups, width, dtype)
            + _itemsize(dtype) * 2 * int(n_pairs) * LANES + 4 * int(n_pairs))


def _k5_sizes(coords, n1, groups, width, dtype):
    # in the order of K5's kernels: the paired layout first
    return (paired_smem_bytes(n1, pair_count(coords, n1), groups, width,
                              dtype),
            smem_bytes(n1, groups, width, dtype))


def _k5_tables(layout, kernel, dtype):
    if kernel == "paired":
        recs, words = paired_records(layout, dtype)
        return (layout.lengths, None), (recs, None), (words, None)
    return (layout.lengths, None), (quartic_records(layout, dtype), None)


def _k5_run(kernel, tables, n1, y, dts, write_every):
    global launches, launches_paired
    if kernel == "paired":
        lengths, recs, words = tables
        out, records, launched = run_records(
            "rk4_paired", _PAIRED_FNS[y.dtype], (lengths, recs), n1, y, dts,
            write_every, words.data_ptr(), words.numel())
        launches_paired += launched
    else:
        out, records, launched = run_records(
            "rk4_quartic", _FNS[y.dtype], tables, n1, y, dts, write_every)
    launches += launched
    return out, records


# K5: one resident kernel over either layout, no plain version on the CPU;
# the paired layout wherever it fits (on an H100 it is the faster on every
# rank-5 tensor measured: T4 and dynamic-T, float64 and float32, PERF.md).
# G = 16 for every tensor: a stage lasts as long as the longest group's
# chain of chunks, and 16 warps keep the SM's shared-memory pipe busier than
# 8.  On an H100 the T4 tendency (longest tables 430 records at G = 16, 744
# at 8, its longest row 428 entries) runs 4096 trajectories x 500 steps in
# 61.0 ms at G = 16 against 81.0 ms at G = 8 in the four-gather layout
# (``chip_smoke.py`` phase 7), dynamic-T in 5.7 against 7.3
K5 = KernelFamily("rk4_quartic", Tendency, 5, (torch.float32, torch.float64),
                  False, MAX_N1, 16, _k5_sizes, _k5_tables, _k5_run, None,
                  quartic_layout, kernels=("paired", "resident"))


def fused_rk4_quartic(f, y, dts, write_every=0):
    """Advance the (B, n) CUDA state ``y`` by ``len(dts)`` RK4 steps of the
    rank-5 tendency module ``f`` (a
    :class:`~qgs_tpu_torch.ops.contraction.Tendency`) in one launch of K5
    (:meth:`~qgs_tpu_torch.ops.fused_rk4.KernelFamily.launch` of
    :data:`K5`); ``dts`` (n_steps,) float64 on ``y``'s device.

    Returns ``(y_final, records)``, records (n_steps // write_every, B, n)
    holding the state after every ``write_every`` steps.  ``y`` is not
    modified.  Raises for a state off the card, a tensor past the kernel's
    8-bit indices (``ValueError``), and a layout that does not fit the
    card's shared memory a block (``RuntimeError``, from the tendency's
    launch plan)."""
    return K5.launch(f, y, dts, write_every)
