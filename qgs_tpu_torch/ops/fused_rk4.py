"""
Fused RK4 kernel
================

Wrapper of the CUDA kernel ``csrc/rk4_fused.cu``, the Hopper port of the TPU
kernel ``make_pallas_rk4_f32`` (``qgs_tpu/ops/pallas_kernels.py:210``): it
advances a batch of states by ``len(dts)`` classical RK4 steps of a rank-3
quadratic tendency in one launch, step ``s`` of size ``dts[s]``, and records
the state every ``write_every`` steps.

* :func:`fused_rk4` launches the kernel for a CUDA state, in float32 or
  float64, and counts the launch in :data:`launches`.  For a CPU state it
  runs the plain version instead (the kernel has no CPU build).
* :func:`fused_rk4_reference` is the plain PyTorch version: the same RK4
  formula (``qgs_tpu.integrators.rk.make_rk_step``'s, term by term) over the
  plain contraction :class:`~qgs_tpu_torch.ops.contraction.Tendency`.
* :func:`group_layout` is the kernel's tensor layout, and the double-float
  kernel's (:mod:`qgs_tpu_torch.ops.fused_df_rk4`): the output rows split
  into G groups of about equal entry count, one warp of a block each,
  every group a flat table of entry records.  :func:`group_tendency`
  evaluates the tendency through that layout in plain PyTorch, group by
  group, in the kernel's summation order.
* :func:`csr_layout` is the row-sorted list of entries that
  :func:`group_layout` is built from, and :func:`row_groups` its rows'
  assignment to groups, from the per-row entry counts alone.
* :func:`fits` says, before any launch, whether the kernel's layout of a
  tendency fits one block's opt-in shared memory (:func:`smem_bytes`, the
  launcher's own formula).
* The streamed kernel ``csrc/rk4_streamed.cu`` is the same port for
  tensors whose records do not fit: the records stay in device memory
  (:func:`streamed_records`, ``group_layout``'s tables as 16-byte records
  padded to whole ring tiles; :func:`streamed_tendency` evaluates them in
  plain PyTorch) and only the two stage inputs stay in shared memory
  (:func:`streamed_smem_bytes`, :func:`streamed_fits`).  Its launches
  count in :data:`launches_streamed`.
* :func:`choose_kernel` decides by size, before any launch, which of the
  two runs a tendency: the resident one when it fits, else the streamed
  one when it fits, else neither (the integrators then take the plain
  step loop, and :func:`fused_rk4` raises).
* :func:`launch_plan` is a tendency's launch plan, kept on its module and
  built once a key: the kernel the route takes and, from the plan's first
  launch of a kernel on, its :func:`group_layout` and that kernel's device
  tables (:func:`plan_tables`, which both launchers call).  A launch looks
  its plan up under the span ``qgs.layout`` and, where the plan is new,
  uploads its tables under ``qgs.layout_in``
  (:func:`~qgs_tpu_torch.utils.profiling.span`, recorded only under a
  profiler); :data:`layout_builds` counts the :func:`group_layout` calls,
  :data:`plan_hits` the launches served by a stored plan.
"""

from __future__ import annotations

import heapq
from typing import Callable, NamedTuple

import numpy as np
import torch

from qgs_tpu_torch.ops import _build
from qgs_tpu_torch.ops.contraction import _with_dummy
from qgs_tpu_torch.utils.profiling import span

launches = 0             # kernel launches in this process (plain runs excluded)
launches_streamed = 0    # the same for the streamed kernel
layout_builds = 0        # group_layout calls in this process (both kernels')
plan_hits = 0            # launches whose tables a stored plan held (every
                         # family's: K1's, K2's and K5's)

_FNS = {torch.float32: "qgs_rk4_fused_f32", torch.float64: "qgs_rk4_fused_f64"}
_STREAMED_FNS = {torch.float32: "qgs_rk4_streamed_f32",
                 torch.float64: "qgs_rk4_streamed_f64"}

GROUPS = (1, 2, 4, 8)    # the kernel's choices of row groups (warps) a block
# where the caller sets none, for this kernel and the double-float one: on
# the H100, G = 8 ties G = 4 at B = 16384 in float64 and is the fastest of
# GROUPS at B = 4096 and 16384 otherwise (PERF.md, Findings), so no rule on
# B is needed yet
DEFAULT_GROUPS = 8
CHUNK = 2                # entries a chunk: the kernel's partial sums a row
AHEAD = 1                # chunks the kernel reads past a group's end
LAST = 1 << 16           # ctl flag: the chunk ends its row
LANES = 32               # trajectories a block, one a lane
REC_BYTES = 16           # an entry record in shared memory (Rec<T>)
# the streamed kernels' rings (csrc/stream_ring.cuh): records a slot (a
# tile), slots a warp
TILE = 32
SLOTS = 4


class GroupLayout(NamedTuple):
    """The kernel's tables of entry records, one row of each per group:
    ``jk`` (G, W) int32 ``j | k << 16``, ``ctl`` (G, W) int32 state row
    ``i`` (0-based, ``xx`` row ``i + 1``) ``| LAST`` on the row's last
    chunk, ``vals`` (G, W) float64; ``lengths`` (G,) int32 records of each
    group (whole chunks); ``group_of_row`` (n,) the group of each state
    row.  Past each group's length the records are zero, at least
    :data:`AHEAD` chunks of them (the kernel reads that far ahead)."""
    jk: np.ndarray
    ctl: np.ndarray
    vals: np.ndarray
    lengths: np.ndarray
    group_of_row: np.ndarray


def csr_layout(coords, data, shape):
    """Row-sorted entries of a rank-3 COO tensor for the kernel.

    Entries of output row 0 (the dummy) are dropped; the others keep their
    COO order within a row.  Returns ``(row_ptr (n1 + 1,) int32,
    jk (nnz,) int32 holding j | k << 16, vals (nnz,) float64)``."""
    if len(shape) != 3:
        raise NotImplementedError("the fused RK4 kernel takes rank-3 tensors")
    if int(shape[0]) > 1 << 15:
        raise ValueError(f"n1 = {shape[0]} exceeds the kernel's 15-bit "
                         "indices")
    row_ptr, (j, k), vals = csr_rows(coords, data, shape)
    return row_ptr, (j | (k << 16)).astype(np.int32), vals


def csr_rows(coords, data, shape):
    """The entries of a COO tensor sorted by output row, for a kernel's
    layout: those of output row 0 (the dummy) dropped, the others in
    their COO order within a row.  Returns ``(row_ptr (n1 + 1,) int32,
    trailing (rank - 1, nnz) int64 indices, vals (nnz,) float64)``."""
    coords = np.asarray(coords, np.int64)
    data = np.asarray(data, np.float64)
    keep = coords[0] != 0
    order = np.argsort(coords[0][keep], kind="stable")
    row_ptr = np.zeros(int(shape[0]) + 1, np.int32)
    row_ptr[1:] = np.cumsum(np.bincount(coords[0][keep][order],
                                        minlength=int(shape[0])))
    return row_ptr, coords[1:, keep][:, order], data[keep][order]


class RowGroups(NamedTuple):
    """The rows' assignment to groups that :func:`group_layout` lays out:
    ``counts`` (n,) entries of each state row, ``padded`` (n,) its records
    (whole chunks, at least one), ``group_of_row`` (n,), ``load``
    (groups,) records of each group, and ``width`` the records a group's
    table holds (the longest group plus :data:`AHEAD` chunks)."""
    counts: np.ndarray
    padded: np.ndarray
    group_of_row: np.ndarray
    load: np.ndarray
    width: int


def row_groups(coords, n1, groups):
    """Assign the output rows of a rank-3 COO tensor (``coords[0]`` its
    output rows, ``n1`` its first dimension) to ``groups`` groups, from the
    per-row entry counts alone (no record is built): each row's entries
    (output row 0, the dummy, dropped) are padded to whole chunks of
    :data:`CHUNK`, a row without entries gets one chunk, and rows go to
    groups longest first, each to the group with the fewest records so far
    (the lowest such group on a tie).  Returns a :class:`RowGroups`."""
    n1 = int(n1)
    counts = np.bincount(np.asarray(coords[0], np.int64), minlength=n1)[1:]
    padded = np.maximum(-(-counts // CHUNK), 1) * CHUNK
    group_of_row = np.empty(n1 - 1, np.int64)
    heap = [(0, g) for g in range(groups)]      # (records so far, group)
    for i in np.argsort(-padded, kind="stable").tolist():
        load, g = heap[0]
        group_of_row[i] = g
        heapq.heapreplace(heap, (load + int(padded[i]), g))
    load = np.zeros(groups, np.int64)
    for total, g in heap:
        load[g] = total
    return RowGroups(counts, padded, group_of_row, load,
                     int(load.max(initial=0)) + AHEAD * CHUNK)


def group_layout(coords, data, shape, groups, rows=None):
    """Split the output rows of a rank-3 COO tensor into ``groups`` groups
    for the kernel (a :class:`GroupLayout`), as :func:`row_groups` assigns
    them (``rows``, that assignment where the caller has it); a group lists
    its rows in increasing order, each row's entries in COO order, padded
    with zero entries to its chunks (so that the kernel still writes a row
    without entries).  Counts the call in :data:`layout_builds`."""
    global layout_builds
    layout_builds += 1
    rg = rows if rows is not None else row_groups(coords, shape[0], groups)
    return GroupLayout(*fill_groups(*csr_layout(coords, data, shape), rg))


def fill_groups(row_ptr, words, vals, rg):
    """The group tables of row-sorted entries (``row_ptr`` (n1 + 1,), each
    entry's index word ``words`` and value ``vals``) as the
    :class:`RowGroups` ``rg`` assigns their rows: ``(words (G, W) int32,
    ctl (G, W) int32, vals (G, W) float64, lengths (G,) int32,
    group_of_row)``, a group's rows in increasing order, each row's
    entries in their order, padded with zero entries to its chunks."""
    groups, counts, padded = len(rg.load), rg.counts, rg.padded
    out = (np.zeros((groups, rg.width), np.int32),
           np.zeros((groups, rg.width), np.int32),
           np.zeros((groups, rg.width)), rg.load.astype(np.int32),
           rg.group_of_row)
    table, ctl, table_vals = out[:3]
    for g in range(groups):
        pos = 0
        for i in np.flatnonzero(rg.group_of_row == g):
            e = slice(row_ptr[i + 1], row_ptr[i + 2])
            table[g, pos:pos + counts[i]] = words[e]
            table_vals[g, pos:pos + counts[i]] = vals[e]
            ctl[g, pos:pos + padded[i]] = i
            ctl[g, pos + padded[i] - CHUNK:pos + padded[i]] |= LAST
            pos += padded[i]
    return out


def smem_bytes(n1, groups, width, dtype):
    """Shared memory of one block of the kernel in ``dtype`` (float32 or
    float64) for a layout of ``groups`` tables of ``width`` records over a
    tensor of first dimension ``n1``: the records, then four state rows of
    ``n1`` or ``n`` lanes (``smem_bytes`` of ``csrc/rk4_fused.cu``, which
    ``chip_smoke.py`` holds this against)."""
    if dtype not in _FNS:
        raise TypeError(f"dtype {dtype}: the kernel takes float32 or float64")
    itemsize = 8 if dtype == torch.float64 else 4
    n1 = int(n1)
    return (REC_BYTES * groups * width
            + itemsize * (2 * (n1 - 1) + 2 * n1) * LANES)


def fits(f, dtype, device, groups=DEFAULT_GROUPS, limit=None):
    """Whether the kernel can run the rank-3 tendency ``f`` (a module that
    carries ``coords`` and ``shape``) in ``dtype`` on ``device``: its
    :func:`smem_bytes` at most ``limit`` bytes, by default the opt-in
    shared memory of one block of that card, which the launcher checks
    too (:func:`~qgs_tpu_torch.ops._build.max_smem_optin`)."""
    width = row_groups(f.coords, f.shape[0], groups).width
    if limit is None:
        limit = _build.max_smem_optin(device)
    return smem_bytes(f.shape[0], groups, width, dtype) <= limit


def ring_bytes(groups):
    """Shared memory of the streamed kernels' rings for ``groups`` warps:
    :data:`SLOTS` tiles of :data:`TILE` records a warp (``ring_bytes`` of
    ``csrc/stream_ring.cuh``)."""
    return groups * SLOTS * TILE * REC_BYTES


def streamed_smem_bytes(n1, groups, dtype):
    """Shared memory of one block of the streamed kernel in ``dtype``
    (float32 or float64) over a tensor of first dimension ``n1``: the
    rings, then the two stage inputs of ``n1`` rows of :data:`LANES` lanes
    (``streamed_smem_bytes`` of ``csrc/rk4_streamed.cu``, which
    ``chip_smoke.py`` holds this against).  The records do not count: they
    stay in device memory."""
    if dtype not in _FNS:
        raise TypeError(f"dtype {dtype}: the kernel takes float32 or float64")
    itemsize = 8 if dtype == torch.float64 else 4
    return ring_bytes(groups) + itemsize * 2 * int(n1) * LANES


def streamed_fits(f, dtype, device, groups=DEFAULT_GROUPS, limit=None):
    """Whether the streamed kernel can run the rank-3 tendency ``f`` in
    ``dtype`` on ``device``: its :func:`streamed_smem_bytes` at most
    ``limit`` bytes, by default the opt-in shared memory of one block of
    that card."""
    if limit is None:
        limit = _build.max_smem_optin(device)
    return streamed_smem_bytes(f.shape[0], groups, dtype) <= limit


def pick_kernel(sizes, limit):
    """The kernel of every launcher's choice, from the shared memory of the
    resident and the streamed layouts, ``sizes`` (None where the family
    has no such kernel, or it cannot take the tensor): ``"resident"`` when
    the first is at most ``limit`` bytes, else ``"streamed"`` when the
    second is, else ``None``."""
    if sizes[0] is not None and sizes[0] <= limit:
        return "resident"
    if sizes[1] is not None and sizes[1] <= limit:
        return "streamed"
    return None


def choose_kernel(f, dtype, device, groups=DEFAULT_GROUPS, limit=None):
    """Which kernel :func:`fused_rk4` launches for the rank-3 tendency
    ``f`` in ``dtype`` on ``device``: ``"resident"`` when its layout
    :func:`fits`, else ``"streamed"`` when :func:`streamed_fits`, else
    ``None``.  ``limit`` as for :func:`fits`."""
    if limit is None:
        limit = _build.max_smem_optin(device)
    width = row_groups(f.coords, f.shape[0], groups).width
    return pick_kernel(K1.sizes(f.shape[0], groups, width, dtype), limit)


def pack_records(layout, words):
    """The streamed kernels' records of ``layout`` (a :class:`GroupLayout`
    of G tables of W records): int32 (G, W', 4), W' the width rounded up
    to whole :data:`TILE` s, record ``[g, e]`` the 16 bytes ``{jk, ctl,
    words[g, e, 0], words[g, e, 1]}``, zero past W.  ``words`` (G, W, 2)
    int32 holds each value's bytes."""
    G, W = layout.jk.shape
    out = np.zeros((G, -(-W // TILE) * TILE, 4), np.int32)
    out[:, :W, 0] = layout.jk
    out[:, :W, 1] = layout.ctl
    out[:, :W, 2:] = words
    return out


def value_words(vals, dtype):
    """Each value of ``vals`` in ``dtype`` as two int32 words, ``(...,
    2)``: a float64 value in its two words (little-endian: low word
    first), a float32 value in the first word and 0 in the second."""
    vals = np.asarray(vals, "<f8")
    if dtype == torch.float64:
        return vals.view("<i4").reshape(vals.shape + (2,))
    if dtype == torch.float32:
        return np.stack([vals.astype("<f4").view("<i4"),
                         np.zeros(vals.shape, np.int32)], axis=-1)
    raise TypeError(f"dtype {dtype}: the kernel takes float32 or float64")


def streamed_records(layout, dtype):
    """:func:`pack_records` of ``layout`` with each value in ``dtype``
    (:func:`value_words`)."""
    return pack_records(layout, value_words(layout.vals, dtype))


def streamed_tendency(recs, lengths, x):
    """The tendency of the (B, n) state ``x`` through the streamed
    kernel's records ``recs`` (:func:`streamed_records` in ``x``'s dtype)
    and the groups' ``lengths``, in plain PyTorch: each value decoded from
    its words as the kernel decodes it, the entries summed in the kernel's
    order (:func:`group_tendency`)."""
    recs = np.ascontiguousarray(recs, np.int32)
    if x.dtype == torch.float64:
        vals = np.ascontiguousarray(recs[..., 2:]).view("<f8")[..., 0]
    else:
        vals = np.ascontiguousarray(recs[..., 2]).view("<f4")
    layout = GroupLayout(recs[..., 0], recs[..., 1],
                         vals.astype(np.float64), np.asarray(lengths), None)
    return group_tendency(layout, x)


def group_tendency(layout, x):
    """The tendency of the (B, n) state ``x`` through ``layout``, in plain
    PyTorch and in the kernel's order: group by group, slot ``s`` of each
    chunk of a row summed in order into partial sum ``s``, the partial sums
    added at the row's end."""
    xx = _with_dummy(x)
    out = torch.zeros_like(x)
    for g, length in enumerate(layout.lengths.tolist()):
        jk = torch.as_tensor(layout.jk[g, :length], device=x.device)
        rows = torch.as_tensor(layout.ctl[g, :length] & (LAST - 1),
                               device=x.device)
        vals = torch.as_tensor(layout.vals[g, :length], dtype=x.dtype,
                               device=x.device)
        prod = vals * xx[:, jk & 0xffff] * xx[:, jk >> 16]
        parts = [torch.zeros_like(x).index_add_(1, rows[s::CHUNK],
                                                prod[:, s::CHUNK])
                 for s in range(CHUNK)]
        out += sum(parts[1:], parts[0])
    return out


def scaled_dt(dt, c, dtype):
    """``dt * c`` as the RK steps round it (``make_rk_step`` of both
    packages, and the kernel): dt cast to the state dtype, then multiplied
    by the tableau coefficient c in that dtype."""
    return float(torch.tensor(dt, dtype=dtype) * float(c))


def rk4_step(f, y, dt):
    """One classical RK4 step of ``f`` in ``make_rk_step``'s formula and
    order: stage inputs ``y + (dt*a)*k``, then ``y_new = y + sum_i
    (dt*b_i)*k_i`` accumulated left to right."""
    h = scaled_dt(dt, 0.5, y.dtype)
    w1 = scaled_dt(dt, 1.0 / 6.0, y.dtype)
    w2 = scaled_dt(dt, 1.0 / 3.0, y.dtype)
    d = scaled_dt(dt, 1.0, y.dtype)
    k1 = f(0., y)
    k2 = f(0., y + h * k1)
    k3 = f(0., y + h * k2)
    k4 = f(0., y + d * k3)
    return y + w1 * k1 + w2 * k2 + w2 * k3 + w1 * k4


def fused_rk4_reference(f, y, dts, write_every=0):
    """Plain PyTorch version of :func:`fused_rk4`: ``(y_final, records)``
    with ``records`` (len(dts) // write_every, B, n), the state after every
    ``write_every`` steps (empty for ``write_every == 0``)."""
    recs = []
    for s, dt in enumerate(torch.as_tensor(dts).tolist()):
        y = rk4_step(f, y, dt)
        if write_every and (s + 1) % write_every == 0:
            recs.append(y)
    if recs:
        return y, torch.stack(recs)
    return y, y.new_empty((0,) + tuple(y.shape))


def check_steps(y, dts, write_every):
    """The checks the fused kernels' wrappers share: ``dts`` and
    ``write_every`` as the kernels read them, and the kernels' int32
    counts."""
    if (dts.dtype != torch.float64 or dts.dim() != 1
            or dts.device != y.device or not dts.is_contiguous()):
        raise ValueError("dts must be a contiguous 1-D float64 tensor on the "
                         "state's device")
    if write_every < 0:
        raise ValueError(f"write_every = {write_every} < 0")
    if y.shape[0] >= 1 << 31 or dts.numel() >= 1 << 31:
        raise ValueError("batch or step count exceeds the kernel's int32")


def start_run(y, n_steps, write_every):
    """A copy of ``y`` for a kernel to advance in place, and its empty
    records (n_steps // write_every, B, n)."""
    n_rec = n_steps // write_every if write_every else 0
    return y.clone(), y.new_empty((n_rec,) + tuple(y.shape))


def raise_on_error(err, kernel):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")


def _check(f, y, dts, write_every):
    if not hasattr(f, "coords"):
        raise TypeError("fused_rk4 needs a Tendency module (it carries the "
                        "rank-3 tensor the kernel runs)")
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


def no_kernel_fits(name, sizes, n1, limit, device):
    """The error of a launcher whose tendency fits neither kernel;
    ``sizes`` the resident and streamed layouts' bytes (the second None
    for a family without a streamed kernel), ``limit`` the shared memory a
    block on ``device``."""
    if sizes[1] is None:
        return RuntimeError(
            f"{name} cannot launch: its layout ({sizes[0]} B) of a tensor "
            f"of n1 = {n1} does not fit the {limit} B of shared memory a "
            f"block on {device}")
    return RuntimeError(
        f"{name} cannot launch: neither the resident layout ({sizes[0]} B) "
        f"nor the streamed one ({sizes[1]} B) of a tensor of n1 = {n1} fits "
        f"the {limit} B of shared memory a block on {device}")


class KernelFamily(NamedTuple):
    """What a launch plan needs of a family of fused kernels (the resident
    and the streamed one of K1, or of the double-float K2, or the rank-5
    K5 alone): its ``name`` (the resident launcher's, a part of the plan's
    key), ``sizes(n1, groups, width, dtype)`` the resident and the
    streamed layouts' shared memory (:func:`pick_kernel`), ``tables(layout,
    kernel, dtype)`` a kernel's tables of its layout, ``(array, dtype)``
    pairs in the launcher's order (dtype None uploads the array in its
    own), and ``layout(coords, data, shape, groups, rows)`` that layout
    (:func:`group_layout` by default)."""
    name: str
    sizes: Callable
    tables: Callable
    layout: Callable = group_layout


def _k1_sizes(n1, groups, width, dtype):
    return (smem_bytes(n1, groups, width, dtype),
            streamed_smem_bytes(n1, groups, dtype))


def _k1_tables(layout, kernel, dtype):
    if kernel == "streamed":
        return (layout.lengths, None), (streamed_records(layout, dtype), None)
    return ((layout.lengths, None), (layout.jk, None), (layout.ctl, None),
            (layout.vals, dtype))


K1 = KernelFamily("rk4_fused", _k1_sizes, _k1_tables)


class _Plans(dict):
    """A module's launch plans by key, all built from its arrays ``coords``
    and ``data``.  A copy of the module (a mesh's replica on another card)
    starts with none: its plans are its own."""

    def __init__(self, coords=None, data=None):
        super().__init__()
        self.coords, self.data = coords, data

    def __reduce__(self):
        return _Plans, ()


class LaunchPlan:
    """A tendency's launch plan for one kernel family, dtype, device,
    ``groups`` and shared-memory ``limit`` (:func:`launch_plan`): the
    arrays it was built from (``coords``, ``data``, ``shape``), its rows'
    :class:`RowGroups` (``rows``), the resident and the streamed layouts'
    bytes (``sizes``) and the kernel the route takes (``kernel``:
    ``"resident"``, ``"streamed"`` or ``None``, :func:`pick_kernel`);
    from the first launch of a kernel on (:func:`plan_tables`), the
    family's layout (``layout``) and that kernel's device tables
    (``tables``, kernel -> tuple of tensors in the launcher's order)."""

    def __init__(self, f, family, dtype, device, groups, limit):
        self.coords, self.data, self.shape = f.coords, f.data, f.shape
        self.device, self.limit = device, limit
        self.rows = row_groups(f.coords, f.shape[0], groups)
        self.sizes = family.sizes(f.shape[0], groups, self.rows.width, dtype)
        self.kernel = pick_kernel(self.sizes, limit)
        self.layout = None
        self.tables = {}


def launch_plan(f, family, dtype, device, groups=DEFAULT_GROUPS, limit=None):
    """The launch plan (a :class:`LaunchPlan`) of the tendency ``f`` for
    the kernel ``family`` (:data:`K1`, or
    :data:`~qgs_tpu_torch.ops.fused_df_rk4.DF`, of a rank-3 tendency;
    :data:`~qgs_tpu_torch.ops.fused_rk4_quartic.K5` of a rank-5 one) in
    ``dtype`` on ``device``, with ``groups`` row groups and ``limit``
    bytes of shared memory a block (by default the card's,
    :func:`~qgs_tpu_torch.ops._build.max_smem_optin`).

    The plan is kept on ``f`` (``f.launch_plans``) under ``(family name,
    dtype, device, groups, limit)``, so that a smaller limit (a test's)
    gets a plan of its own, and built anew, with the module's other plans
    dropped, once ``f.coords`` or ``f.data`` is no longer the array it was
    built from.  A change made inside those arrays in place is not seen, as
    the plain contraction's layout, built when the module is, does not see
    it either."""
    device = torch.device(device)
    if limit is None:
        limit = _build.max_smem_optin(device)
    plans = getattr(f, "launch_plans", None)
    if (plans is None or plans.coords is not f.coords
            or plans.data is not f.data):
        plans = f.launch_plans = _Plans(f.coords, f.data)
    key = (family.name, dtype, device, groups, limit)
    plan = plans.get(key)
    if plan is None:
        plan = plans[key] = LaunchPlan(f, family, dtype, device, groups,
                                       limit)
    return plan


def plan_tables(f, family, kernel, dtype, device, groups=DEFAULT_GROUPS,
                limit=None):
    """``(kernel, tables)`` of a launch of the tendency ``f`` (both
    launchers' one path to their tables): ``kernel`` where it is forced,
    else its plan's choice (:func:`launch_plan`, looked up under the span
    ``qgs.layout``), and that kernel's device tables.  The plan's first
    launch of a kernel builds them (its :func:`group_layout` once a plan,
    under ``qgs.layout``) and uploads them (under ``qgs.layout_in``); every
    later one takes the stored tables and counts in :data:`plan_hits`.
    Raises where the plan's choice is no kernel."""
    global plan_hits
    with span("qgs.layout"):
        plan = launch_plan(f, family, dtype, device, groups, limit)
        kernel = kernel or plan.kernel
        if kernel is None:
            raise no_kernel_fits(family.name, plan.sizes, plan.shape[0],
                                 plan.limit, plan.device)
        if kernel in plan.tables:
            plan_hits += 1
            return kernel, plan.tables[kernel]
        if plan.layout is None:
            plan.layout = family.layout(plan.coords, plan.data, plan.shape,
                                        groups, plan.rows)
        host = family.tables(plan.layout, kernel, dtype)
    with span("qgs.layout_in"):
        tables = plan.tables[kernel] = tuple(
            torch.as_tensor(a, dtype=t, device=plan.device) for a, t in host)
    return kernel, tables


def fused_rk4(f, y, dts, write_every=0, groups=DEFAULT_GROUPS):
    """Advance the (B, n) state ``y`` by ``len(dts)`` RK4 steps of the
    tendency module ``f`` (a :class:`~qgs_tpu_torch.ops.contraction.Tendency`)
    in one kernel launch; ``dts`` (n_steps,) float64 on ``y``'s device.
    ``groups`` (one of :data:`GROUPS`) sets the kernel's row groups a block.
    :func:`choose_kernel` decides by size which kernel runs.

    Returns ``(y_final, records)``, records (n_steps // write_every, B, n)
    holding the state after every ``write_every`` steps.  ``y`` is not
    modified.  A CPU state runs :func:`fused_rk4_reference`; a CUDA state
    launches a kernel or raises (``RuntimeError`` for a tendency that fits
    neither kernel)."""
    return _launch(None, f, y, dts, write_every, groups)


def _launch(kernel, f, y, dts, write_every=0, groups=DEFAULT_GROUPS):
    """:func:`fused_rk4` with ``kernel``, ``"resident"`` or ``"streamed"``,
    forced (the checks that hold the two kernels bit for bit call this), or
    the launch plan's choice where it is None (:func:`plan_tables`).  A
    forced kernel whose layout does not fit raises the launcher's
    ``RuntimeError``."""
    global launches, launches_streamed
    if groups not in GROUPS:
        raise ValueError(f"groups = {groups}: the kernel takes one of "
                         f"{GROUPS}")
    if y.device.type == "cpu":
        return fused_rk4_reference(f, y, dts, write_every)
    if y.device.type != "cuda":
        raise ValueError(f"fused_rk4 runs on CUDA or CPU, not {y.device}")
    _check(f, y, dts, write_every)
    B = y.shape[0]
    n_steps = dts.numel()
    out, records = start_run(y, n_steps, write_every)
    if B == 0 or n_steps == 0:
        return out, records
    n1 = f.shape[0]
    kernel, tables = plan_tables(f, K1, kernel, y.dtype, y.device, groups)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    if kernel == "streamed":
        lengths, recs = tables
        scratch = y.new_empty((-(-B // LANES), 2, n1 - 1, LANES))
        with torch.cuda.device(y.device):
            err = getattr(lib, _STREAMED_FNS[y.dtype])(
                recs.data_ptr(), lengths.data_ptr(), recs.shape[0],
                recs.shape[1], n1, out.data_ptr(), B, dts.data_ptr(),
                n_steps, write_every, records.data_ptr(), scratch.data_ptr(),
                stream)
        raise_on_error(err, "rk4_streamed")
        launches_streamed += 1
        return out, records
    lengths, jk, ctl, vals = tables
    with torch.cuda.device(y.device):
        err = getattr(lib, _FNS[y.dtype])(
            jk.data_ptr(), ctl.data_ptr(), vals.data_ptr(),
            lengths.data_ptr(), jk.shape[0], jk.shape[1], n1,
            out.data_ptr(), B, dts.data_ptr(), n_steps, write_every,
            records.data_ptr(), stream)
    raise_on_error(err, "rk4_fused")
    launches += 1
    return out, records
