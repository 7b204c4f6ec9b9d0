"""
Fused rank-5 RK4 kernel (K5)
============================

K5's family (:data:`K5`) for the fused RK4 kernels' one seam
(:class:`~qgs_tpu_torch.ops.fused_rk4.KernelFamily`): classical RK4 steps
of a rank-5 (quartic) tendency, ``f_i = sum_e v_e xx[j] xx[k] xx[l] xx[m]``
over ``xx = [1, y]`` (qgs's dynamic-T and full quartic T4 radiation
schemes), in float32 or float64, in one launch of K1's resident kernel
(``csrc/rk4_fused.cu``) over a four-index entry.  It replaces no TPU
kernel (the JAX package's Pallas kernels take rank 3 only).

* :func:`fused_rk4_quartic` launches the kernel for a CUDA state and
  counts the launch in :data:`launches`; anything it cannot run raises
  (the integrators take the plain step loop instead).
* :func:`quartic_layout` is the kernel's tensor layout: the output rows
  split into G groups of about equal entry count (K1's
  :func:`~qgs_tpu_torch.ops.fused_rk4.row_groups`), one warp of a block
  each, every group a flat table of entries whose four trailing indices
  are packed in one word ``j | k << 8 | l << 16 | m << 24``.
  :func:`quartic_records` packs a layout as the kernel's 16-byte records,
  and :func:`quartic_group_tendency` evaluates the tendency through a
  layout in plain PyTorch, in the kernel's summation order.
  :data:`layout_builds` counts the :func:`quartic_layout` calls.
* G is 16 for every tensor (``K5.groups``), and the layout's shared memory
  is K1's resident formula (:func:`~qgs_tpu_torch.ops.fused_rk4.smem_bytes`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qgs_tpu_torch.ops.contraction import Tendency, _with_dummy
from qgs_tpu_torch.ops.fused_rk4 import (CHUNK, LAST, KernelFamily, csr_rows,
                                         fill_groups, pack_records,
                                         row_groups, run_records, smem_bytes,
                                         value_words)

launches = 0             # kernel launches in this process
layout_builds = 0        # quartic_layout calls in this process

_FNS = {torch.float32: "qgs_rk4_quartic_f32",
        torch.float64: "qgs_rk4_quartic_f64"}

MAX_N1 = 256             # an index is one byte of a record's index word


class QuarticLayout(NamedTuple):
    """The kernel's tables of entry records, one row of each per group:
    ``jklm`` (G, W) int32 holding the bits of ``j | k << 8 | l << 16 | m
    << 24``, ``ctl`` (G, W) int32 state row ``i`` (0-based, ``xx`` row
    ``i + 1``) ``| LAST`` on the row's last chunk, ``vals`` (G, W)
    float64; ``lengths`` (G,) int32 records of each group (whole chunks);
    ``group_of_row`` (n,) the group of each state row.  Past each group's
    length the records are zero, at least
    :data:`~qgs_tpu_torch.ops.fused_rk4.AHEAD` chunks of them."""
    jklm: np.ndarray
    ctl: np.ndarray
    vals: np.ndarray
    lengths: np.ndarray
    group_of_row: np.ndarray


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


def quartic_layout(coords, data, shape, groups, rows=None):
    """Split the output rows of a rank-5 COO tensor into ``groups`` groups
    for the kernel (a :class:`QuarticLayout`), as
    :func:`~qgs_tpu_torch.ops.fused_rk4.row_groups` assigns them
    (``rows``, that assignment where the caller has it); a group lists its
    rows in increasing order, each row's entries in COO order, padded with
    zero entries to its chunks (so that the kernel still writes a row
    without entries; a zero entry gathers ``xx[0] = 1`` four times and adds
    0).  Counts the call in :data:`layout_builds`."""
    global layout_builds
    layout_builds += 1
    rg = rows if rows is not None else row_groups(coords, shape[0], groups)
    return QuarticLayout(*fill_groups(*quartic_csr(coords, data, shape), rg))


def quartic_records(layout, dtype):
    """The kernel's records of ``layout`` with each value in ``dtype``:
    int32 (G, W, 4), record ``[g, e]`` the 16 bytes ``{jklm, ctl, value
    words}`` (:func:`~qgs_tpu_torch.ops.fused_rk4.value_words`)."""
    return pack_records(layout.jklm, layout.ctl,
                        value_words(layout.vals, dtype))


def quartic_group_tendency(layout, x):
    """The tendency of the (B, n) state ``x`` through ``layout``, in plain
    PyTorch and in the kernel's order: group by group, each entry's
    product formed as ``(v * a * b) * (c * d)``, slot ``s`` of each chunk
    of a row summed in order into partial sum ``s``, the partial sums added
    at the row's end."""
    xx = _with_dummy(x)
    out = torch.zeros_like(x)
    for g, length in enumerate(layout.lengths.tolist()):
        a, b, c, d = (torch.as_tensor(i, device=x.device)
                      for i in unpack(layout.jklm[g, :length]))
        rows = torch.as_tensor(layout.ctl[g, :length] & (LAST - 1),
                               device=x.device)
        vals = torch.as_tensor(layout.vals[g, :length], dtype=x.dtype,
                               device=x.device)
        prod = (vals * xx[:, a] * xx[:, b]) * (xx[:, c] * xx[:, d])
        parts = [torch.zeros_like(x).index_add_(1, rows[s::CHUNK],
                                                prod[:, s::CHUNK])
                 for s in range(CHUNK)]
        out += sum(parts[1:], parts[0])
    return out


def _k5_sizes(n1, groups, width, dtype):
    return smem_bytes(n1, groups, width, dtype), None


def _k5_tables(layout, kernel, dtype):
    return (layout.lengths, None), (quartic_records(layout, dtype), None)


def _k5_run(kernel, tables, n1, y, dts, write_every):
    global launches
    out, records, launched = run_records("rk4_quartic", _FNS[y.dtype], tables,
                                         n1, y, dts, write_every)
    launches += launched
    return out, records


# K5: one resident kernel, no plain version on the CPU.  G = 16 for every
# tensor: a stage lasts as long as the longest group's chain of chunks, and
# 16 warps keep the SM's shared-memory pipe busier than 8.  On an H100 the
# T4 tendency (longest tables 430 records at G = 16, 744 at 8, its longest
# row 428 entries) runs 4096 trajectories x 500 steps in 61.0 ms at G = 16
# against 81.0 ms at G = 8 (``chip_smoke.py`` phase 7), dynamic-T in 5.7
# against 7.3
K5 = KernelFamily("rk4_quartic", Tendency, 5, (torch.float32, torch.float64),
                  False, MAX_N1, 16, _k5_sizes, _k5_tables, _k5_run, None,
                  quartic_layout)


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
