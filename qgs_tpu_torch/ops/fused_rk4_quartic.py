"""
Fused rank-5 RK4 kernel (K5)
============================

Wrapper of the CUDA kernel ``csrc/rk4_quartic.cu``: it advances a batch of
states by ``len(dts)`` classical RK4 steps of a rank-5 (quartic) tendency,
``f_i = sum_e v_e xx[j] xx[k] xx[l] xx[m]`` over ``xx = [1, y]`` (qgs's
dynamic-T and full quartic T4 radiation schemes), in one launch, step ``s``
of size ``dts[s]``, and records the state every ``write_every`` steps.  It
replaces no TPU kernel (the JAX package's Pallas kernels take rank 3 only);
its design is K1's (:mod:`qgs_tpu_torch.ops.fused_rk4`) with a record of
four 8-bit indices.

* :func:`fused_rk4_quartic` launches the kernel for a CUDA state, in
  float32 or float64, and counts the launch in :data:`launches`; anything
  it cannot run raises (the integrators take the plain step loop
  instead).
* :func:`quartic_layout` is the kernel's tensor layout: the output rows
  split into G groups of about equal entry count (K1's
  :func:`~qgs_tpu_torch.ops.fused_rk4.row_groups`), one warp of a block
  each, every group a flat table of entries whose four trailing indices
  are packed in one word ``j | k << 8 | l << 16 | m << 24``.
  :func:`quartic_records` packs a layout as the kernel's 16-byte records,
  and :func:`quartic_group_tendency` evaluates the tendency through a
  layout in plain PyTorch, in the kernel's summation order.
* :data:`GROUPS` is G, the row groups (warps) a block, for every tensor.
* :data:`K5` is the kernel's family for the launch plans of
  :func:`~qgs_tpu_torch.ops.fused_rk4.launch_plan`: a tendency's plan,
  kept on its module, holds whether the layout fits one block's opt-in
  shared memory (:func:`quartic_smem_bytes`, the launcher's own formula)
  and, from its first launch on, the layout and its device tables
  (looked up under the span ``qgs.layout``, uploaded once under
  ``qgs.layout_in``).  :data:`layout_builds` counts the
  :func:`quartic_layout` calls.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qgs_tpu_torch.ops import _build
from qgs_tpu_torch.ops.contraction import Tendency, _with_dummy
from qgs_tpu_torch.ops.fused_rk4 import (CHUNK, LANES, LAST, REC_BYTES,
                                         KernelFamily,
                                         check_steps, csr_rows, fill_groups,
                                         plan_tables, raise_on_error,
                                         row_groups, start_run, value_words)

launches = 0             # kernel launches in this process
layout_builds = 0        # quartic_layout calls in this process

_FNS = {torch.float32: "qgs_rk4_quartic_f32",
        torch.float64: "qgs_rk4_quartic_f64"}

MAX_N1 = 256             # an index is one byte of a record's index word
# The row groups (warps) a block, the kernel's kMaxGroups, for every tensor.
# A stage lasts as long as the longest group's chain of chunks, and 16 warps
# keep the SM's shared-memory pipe busier than 8: on an H100 the T4 tendency
# (longest tables 430 records at G = 16, 744 at 8, its longest row 428
# entries) runs 4096 trajectories x 500 steps in 61.0 ms at G = 16 against
# 81.0 ms at G = 8 (``chip_smoke.py`` phase 7), dynamic-T in 5.7 against 7.3
GROUPS = 16


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


def quartic_smem_bytes(n1, groups, width, dtype):
    """Shared memory of one block of the kernel in ``dtype`` (float32 or
    float64) for a layout of ``groups`` tables of ``width`` records over a
    tensor of first dimension ``n1``: the records, then four state rows of
    ``n1`` or ``n`` lanes (``smem_bytes`` of ``csrc/rk4_quartic.cu``,
    which ``chip_smoke.py`` holds this against)."""
    if dtype not in _FNS:
        raise TypeError(f"dtype {dtype}: the kernel takes float32 or float64")
    itemsize = 8 if dtype == torch.float64 else 4
    n1 = int(n1)
    return (REC_BYTES * groups * width
            + itemsize * (2 * (n1 - 1) + 2 * n1) * LANES)


def quartic_records(layout, dtype):
    """The kernel's records of ``layout`` with each value in ``dtype``:
    int32 (G, W, 4), record ``[g, e]`` the 16 bytes ``{jklm, ctl, value
    words}`` (:func:`~qgs_tpu_torch.ops.fused_rk4.value_words`)."""
    G, W = layout.jklm.shape
    out = np.zeros((G, W, 4), np.int32)
    out[..., 0] = layout.jklm
    out[..., 1] = layout.ctl
    out[..., 2:] = value_words(layout.vals, dtype)
    return out


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
    size = quartic_smem_bytes(n1, groups, width, dtype)
    return (size if int(n1) <= MAX_N1 else None), None


def _k5_tables(layout, kernel, dtype):
    return (layout.lengths, None), (quartic_records(layout, dtype), None)


# K5's launch plans (:func:`~qgs_tpu_torch.ops.fused_rk4.launch_plan`, at
# G = GROUPS): one resident kernel
K5 = KernelFamily("rk4_quartic", _k5_sizes, _k5_tables, quartic_layout)


def _check(f, y, dts, write_every):
    if y.device.type != "cuda":
        raise ValueError(f"fused_rk4_quartic runs on CUDA, not {y.device} "
                         "(the integrators take the plain step loop there)")
    if not isinstance(f, Tendency) or len(f.shape) != 5:
        raise TypeError("fused_rk4_quartic needs a rank-5 Tendency module "
                        "(it carries the tensor the kernel runs)")
    if f.shape[0] > MAX_N1:
        raise ValueError(f"n1 = {f.shape[0]} exceeds the kernel's 8-bit "
                         f"indices (n1 <= {MAX_N1})")
    if y.dtype not in _FNS:
        raise TypeError(f"state dtype {y.dtype}: the kernel takes float32 or "
                        "float64")
    if y.dtype != f.dtype:
        raise TypeError(f"state dtype {y.dtype} differs from the tendency's "
                        f"{f.dtype}")
    if y.dim() != 2 or y.shape[1] != f.shape[0] - 1:
        raise ValueError(f"state shape {tuple(y.shape)}: expected (B, "
                         f"{f.shape[0] - 1})")
    if not y.is_contiguous():
        raise ValueError("state must be contiguous")
    check_steps(y, dts, write_every)


def fused_rk4_quartic(f, y, dts, write_every=0):
    """Advance the (B, n) CUDA state ``y`` by ``len(dts)`` RK4 steps of the
    rank-5 tendency module ``f`` (a
    :class:`~qgs_tpu_torch.ops.contraction.Tendency`) in one kernel
    launch; ``dts`` (n_steps,) float64 on ``y``'s device.

    Returns ``(y_final, records)``, records (n_steps // write_every, B, n)
    holding the state after every ``write_every`` steps.  ``y`` is not
    modified.  Raises for a state off the card, a tensor past the kernel's
    8-bit indices (``ValueError``), and a layout that does not fit the
    card's shared memory a block (``RuntimeError``, from the tendency's
    launch plan)."""
    _check(f, y, dts, write_every)
    _, tables = plan_tables(f, K5, None, y.dtype, y.device, GROUPS)
    return _run(tables, f.shape[0], y, dts, write_every)


def _run(tables, n1, y, dts, write_every):
    """One launch of the kernel over the device ``tables`` (a launch
    plan's, :func:`~qgs_tpu_torch.ops.fused_rk4.plan_tables`) of a tensor
    of first dimension ``n1``, the state and steps already checked; counts
    in :data:`launches`."""
    global launches
    out, records = start_run(y, dts.numel(), write_every)
    B, n_steps = y.shape[0], dts.numel()
    if B == 0 or n_steps == 0:
        return out, records
    lengths, recs = tables
    lib = _build.load_library()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        err = getattr(lib, _FNS[y.dtype])(
            recs.data_ptr(), lengths.data_ptr(), recs.shape[0],
            recs.shape[1], n1, out.data_ptr(), B, dts.data_ptr(), n_steps,
            write_every, records.data_ptr(), stream)
    raise_on_error(err, "rk4_quartic")
    launches += 1
    return out, records
