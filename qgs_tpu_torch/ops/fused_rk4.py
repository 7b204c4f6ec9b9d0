"""
Fused RK4 kernels
=================

The port's fused RK4 kernels advance a batch of states by ``len(dts)``
classical RK4 steps of a sparse polynomial tendency in one launch, step
``s`` of size ``dts[s]``, and record the state every ``write_every`` steps.
Their one seam is the kernel family (:class:`KernelFamily`): a family
decides, from its tendency's launch plan, whether one of its kernels runs
a tendency, and launches it.  There are three:

* :data:`K1` (this module): a rank-3 quadratic tendency in float64 or
  float32, the Hopper port of the TPU kernel ``make_pallas_rk4_f32``
  (``qgs_tpu/ops/pallas_kernels.py:210``).  Its resident kernel
  (``csrc/rk4_fused.cu``) keeps the tensor's records and the state in one
  block's shared memory; its streamed kernel (``csrc/rk4_streamed.cu``)
  keeps the records in device memory and only the two stage inputs on
  chip, and where the batch's blocks leave SMs idle it runs as
  thread-block clusters of ``c`` blocks, which split each block's rows
  (:func:`pick_cluster`); past that its single-buffer variant keeps one
  stage input on chip and the next in device memory.  Launches count in
  :data:`launches` and :data:`launches_streamed` (the clustered ones in
  :data:`launches_clustered` too, the single-buffer ones in
  :data:`launches_1buf`).
* :data:`~qgs_tpu_torch.ops.fused_df_rk4.DF` (K2): the same in
  double-float.
* :data:`~qgs_tpu_torch.ops.fused_rk4_quartic.K5`: a rank-5 quartic
  tendency in float64 or float32, K1's resident kernel over a four-index
  entry, or over a two-index entry of pair products (its paired layout).

A family holds its G (the row groups, one warp each, of a block), the
tendency module, rank and state dtypes it takes (:meth:`KernelFamily.takes`,
the route's test; :meth:`KernelFamily.check`, the launch's), the shared
memory of its layouts, its tables and its launcher.
:meth:`KernelFamily.launch` is every launch's one path; :func:`fused_rk4`
is K1's.

The choice of kernel is made in one place, a tendency's launch plan
(:func:`launch_plan`, kept on its module and built once a key):
``"resident"`` where the resident layout's shared memory fits one block's
opt-in limit of the card, else ``"streamed"`` where the streamed one does,
else ``"streamed_1buf"`` where the single-buffer variant's does, else none
(:func:`pick_kernel`, over the family's own order of kernels: K5's is
``"paired"``, then ``"resident"``).  From the plan's first launch of a
kernel on it also holds the family's layout and that kernel's device tables
(:func:`plan_tables`; for the streamed K1 at ``c > 1`` the tables of a
layout of ``c·G`` groups, and the card's occupancy, queried once a plan).
A launch looks its plan up under the span
``qgs.layout`` and, where the plan is new, uploads its tables under
``qgs.layout_in`` (:func:`~qgs_tpu_torch.utils.profiling.span`, recorded
only under a profiler); :data:`layout_builds` counts the
:func:`group_layout` calls, :data:`plan_hits` the launches of every family
served by a stored plan.

K1's layout: :func:`group_layout` splits the output rows into G groups of
about equal entry count, every group a flat table of entry records
(:func:`csr_layout`, :func:`row_groups`); both K1 kernels read them as
16-byte records (:func:`resident_records`, :func:`streamed_records`,
:func:`pack_records`).  :func:`group_tendency` and
:func:`streamed_tendency` evaluate the tendency through a layout and
through its records in plain PyTorch, in the kernels' summation order;
:func:`fused_rk4_reference` is the plain version of a whole launch.
"""

from __future__ import annotations

import heapq
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from qgs_tpu_torch.ops import _build
from qgs_tpu_torch.ops.contraction import Tendency, _with_dummy
from qgs_tpu_torch.utils.profiling import span

launches = 0             # resident K1 launches in this process
launches_streamed = 0    # streamed K1 launches in this process
launches_clustered = 0   # those of them as clusters of c > 1 blocks
launches_1buf = 0        # those of them by the single-buffer variant
layout_builds = 0        # group_layout calls in this process (K1's and K2's)
plan_hits = 0            # launches whose tables a stored plan held (every
                         # family's: K1's, K2's and K5's)

_FNS = {torch.float32: "qgs_rk4_fused_f32", torch.float64: "qgs_rk4_fused_f64"}
_STREAMED_FNS = {torch.float32: "qgs_rk4_streamed_f32",
                 torch.float64: "qgs_rk4_streamed_f64"}
_1BUF_FNS = {torch.float32: "qgs_rk4_streamed_1buf_f32",
             torch.float64: "qgs_rk4_streamed_1buf_f64"}
# a family's kernels in the order a plan tries them, the sizes of its
# layouts given in the same order (KernelFamily.sizes)
KERNELS = ("resident", "streamed", "streamed_1buf")

CHUNK = 2                # entries a chunk: the kernel's partial sums a row
AHEAD = 1                # chunks the kernel reads past a group's end
LAST = 1 << 16           # ctl flag: the chunk ends its row
LANES = 32               # trajectories a block, one a lane
REC_BYTES = 16           # an entry record (csrc/rk4_common.cuh)
# the streamed kernels' rings (csrc/stream_ring.cuh): records a slot (a
# tile), slots a warp
TILE = 32
SLOTS = 4
MAX_CLUSTER = 8          # the largest portable thread-block cluster


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


def _itemsize(dtype):
    if dtype not in _FNS:
        raise TypeError(f"dtype {dtype}: the kernel takes float32 or float64")
    return 8 if dtype == torch.float64 else 4


def smem_bytes(n1, groups, width, dtype):
    """Shared memory of one block of the resident kernel (K1's or K5's) in
    ``dtype`` (float32 or float64) for a layout of ``groups`` tables of
    ``width`` records over a tensor of first dimension ``n1``: the records,
    then four state rows of ``n1`` or ``n`` lanes (``smem_bytes`` of
    ``csrc/rk4_fused.cu``, which ``chip_smoke.py`` holds this against)."""
    n1 = int(n1)
    return (REC_BYTES * groups * width
            + _itemsize(dtype) * (2 * (n1 - 1) + 2 * n1) * LANES)


def ring_bytes(groups):
    """Shared memory of the streamed kernels' rings for ``groups`` warps:
    :data:`SLOTS` tiles of :data:`TILE` records a warp (``ring_bytes`` of
    ``csrc/stream_ring.cuh``)."""
    return groups * SLOTS * TILE * REC_BYTES


def streamed_smem_bytes(n1, groups, dtype, inputs=2):
    """Shared memory of one block of the streamed kernel in ``dtype``
    (float32 or float64) over a tensor of first dimension ``n1``: the
    rings, then ``inputs`` stage inputs of ``n1`` rows of :data:`LANES`
    lanes, two, or one in the single-buffer variant
    (``streamed_smem_bytes`` of ``csrc/rk4_streamed.cu``, which
    ``chip_smoke.py`` holds this against).  The records do not count: they
    stay in device memory."""
    return ring_bytes(groups) + _itemsize(dtype) * inputs * int(n1) * LANES


def pick_kernel(sizes, limit, kernels=KERNELS):
    """The kernel of a launch plan, from the shared memory of the family's
    layouts, ``sizes``, in the order of its ``kernels`` (by default
    :data:`KERNELS`: the resident, the streamed and the single-buffer
    streamed kernel's; None, or left out, where the family has no such
    kernel or it cannot take the tensor): the first kernel whose size is at
    most ``limit`` bytes, else ``None``."""
    for kernel, size in zip(kernels, sizes):
        if size is not None and size <= limit:
            return kernel
    return None


def pick_cluster(blocks, sms, max_active):
    """``c``, the blocks of a thread-block cluster that the streamed K1
    runs each set of 32 members on, for a launch of ``blocks`` sets on a
    card of ``sms`` SMs that holds ``max_active[c - 1]`` clusters of ``c``
    blocks at once (``cudaOccupancyMaxActiveClusters``; for ``c = 1`` the
    blocks): 1 where the sets fill the SMs, else the ``c`` of the least
    time in this model, the smaller on a tie: the clusters run in waves of
    ``max_active[c - 1]``, each block walking ``1 / c`` of the entries, and
    a wave takes as long as its SM of the most blocks, which it spreads
    evenly over the SMs and which each add a block's time.  Where a block
    has an SM to itself (``c · max_active[c - 1] <= sms``) a wave takes one
    block's time and the model counts waves; where several share an SM it
    counts them whole, which is as slow as they can run (two float32
    blocks at ndim 228 take 1.4 times one's time on an H100).  A ``c`` the
    card holds no cluster of is not taken."""
    if blocks >= sms:
        return 1
    best, cost = 1, None
    for c, active in enumerate(max_active, 1):
        if active < 1:
            continue
        waves, last = divmod(blocks, active)
        time = waves * -(-c * active // sms) + -(-c * last // sms)
        if cost is None or time * cost[1] < cost[0] * c:
            best, cost = c, (time, c)
    return best


def pack_records(index, ctl, words, tile=1):
    """The kernels' 16-byte records of G tables of W entries: int32 (G,
    W', 4), W' the width rounded up to whole ``tile`` s (the streamed
    kernels' rings read whole :data:`TILE` s; 1 for the resident ones),
    record ``[g, e]`` the words ``{index[g, e], ctl[g, e], words[g, e, 0],
    words[g, e, 1]}``, zero past W.  ``index`` (G, W) holds each entry's
    packed indices, ``ctl`` its row and flag, ``words`` (G, W, 2) int32
    its value's bytes."""
    G, W = index.shape
    out = np.zeros((G, -(-W // tile) * tile, 4), np.int32)
    out[:, :W, 0] = index
    out[:, :W, 1] = ctl
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


def resident_records(layout, dtype):
    """The resident K1's records of ``layout`` (a :class:`GroupLayout`),
    each value in ``dtype`` (:func:`value_words`), at the layout's own
    width."""
    return pack_records(layout.jk, layout.ctl,
                        value_words(layout.vals, dtype))


def streamed_records(layout, dtype):
    """The streamed K1's records of ``layout``: :func:`resident_records`
    padded with zero records to whole ring tiles."""
    return pack_records(layout.jk, layout.ctl,
                        value_words(layout.vals, dtype), TILE)


def streamed_tendency(recs, lengths, x):
    """The tendency of the (B, n) state ``x`` through K1's records ``recs``
    (:func:`resident_records` or :func:`streamed_records` in ``x``'s
    dtype) and the groups' ``lengths``, in plain PyTorch: each value
    decoded from its words as the kernels decode it, the entries summed in
    the kernels' order (:func:`group_tendency`)."""
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
    """The checks of ``dts`` and ``write_every`` as the kernels read them,
    and of the kernels' int32 counts."""
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


def no_kernel_fits(name, kernels, sizes, n1, limit, device):
    """The error of a launch whose tendency fits none of its family's
    ``kernels``; ``sizes`` its layouts' bytes in their order (for
    :data:`KERNELS`, the third left out for a family without the
    single-buffer variant), ``limit`` the shared memory a block on
    ``device``."""
    if kernels[:2] != KERNELS[:2]:
        layouts = ", ".join(f"{k} {s} B" for k, s in zip(kernels, sizes))
        return RuntimeError(
            f"{name} cannot launch: its layout of a tensor of n1 = {n1} "
            f"({layouts}) does not fit the {limit} B of shared memory a "
            f"block on {device}")
    streamed = (f"the streamed one ({sizes[1]} B)" if len(sizes) < 3 else
                f"the streamed ones ({sizes[1]} B; single-buffer "
                f"{sizes[2]} B)")
    return RuntimeError(
        f"{name} cannot launch: neither the resident layout ({sizes[0]} B) "
        f"nor {streamed} of a tensor of n1 = {n1} fits the {limit} B of "
        f"shared memory a block on {device}")


def run_records(kernel, fn, tables, n1, y, dts, write_every, *extra):
    """One launch of the C export ``fn`` of ``kernel`` (the resident K1's
    or K5's; the streamed K1's, with the ``extra`` arguments that follow
    its records: its scratch's address and its ``c``) over a launch plan's
    tables ``(lengths, recs)`` of a tensor of first dimension ``n1``, the
    state and steps already checked.  Returns ``(y_final, records,
    launched)``, ``launched`` 1, or 0 where the batch or the steps are
    empty and nothing is launched."""
    out, records = start_run(y, dts.numel(), write_every)
    if y.shape[0] == 0 or dts.numel() == 0:
        return out, records, 0
    lengths, recs = tables
    lib = _build.load_library()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        err = getattr(lib, fn)(
            recs.data_ptr(), lengths.data_ptr(), recs.shape[0], recs.shape[1],
            n1, out.data_ptr(), y.shape[0], dts.data_ptr(), dts.numel(),
            write_every, records.data_ptr(), *extra, stream)
    raise_on_error(err, kernel)
    return out, records, 1


def _dtype_names(dtypes):
    return " or ".join(str(d).replace("torch.", "") for d in dtypes)


class KernelFamily(NamedTuple):
    """A family of fused RK4 kernels (K1's resident and streamed kernels,
    K2's, or K5's resident one): everything a launch needs.  ``name`` is
    the resident kernel's (a part of a launch plan's key); the family runs
    a ``module`` (its tensor of ``rank``) on states of ``dtypes`` (each part
    of a (hi, lo) pair where ``pair``) whose first dimension is at most
    ``max_n1``, with ``groups`` row groups (warps) a block.
    ``sizes(coords, n1, groups, width, dtype)`` gives its layouts' shared
    memory in the order of its ``kernels`` (:data:`KERNELS` unless it says
    otherwise; None, or left out, for a kernel the family lacks),
    ``layout(coords, data, shape, groups, rows)`` the family's layout,
    ``tables(layout, kernel, dtype)`` a kernel's tables of it (``(array,
    dtype)`` pairs in the launcher's order, dtype None for the array's
    own), ``run(kernel, tables, n1, y, dts, write_every)`` one launch on a
    checked CUDA state, counted in the family module's counters, and
    ``reference(f, y, dts, write_every)`` the plain version that a CPU
    state runs (None: a CPU state raises), and ``occupancy(n1, groups,
    dtype, device)`` the card's SMs and its clusters at each ``c`` for the
    family's streamed kernel (:func:`pick_cluster`; None where that kernel
    takes no clusters)."""
    name: str
    module: type
    rank: int
    dtypes: tuple
    pair: bool
    max_n1: int
    groups: int
    sizes: Callable
    tables: Callable
    run: Callable
    reference: Optional[Callable]
    layout: Callable = group_layout
    occupancy: Optional[Callable] = None
    kernels: tuple = KERNELS

    def takes(self, f, y):
        """Whether the family's kernels run the tendency module ``f`` on
        the state ``y`` (a (hi, lo) pair for a double-float family), by the
        module's type, its tensor's rank and the state's dtypes; nothing of
        the card is read."""
        parts = y if isinstance(y, tuple) else (y,)
        return (isinstance(f, self.module) and len(f.shape) == self.rank
                and len(parts) == 1 + self.pair
                and all(p.dtype in self.dtypes for p in parts))

    def check(self, f, y, dts, write_every):
        """The checks of a launch: a CUDA state that the family takes, of
        the tendency's width, contiguous, every part on one card, and the
        steps the kernels read (:func:`check_steps`)."""
        parts = y if isinstance(y, tuple) else (y,)
        y0 = parts[0]
        if y0.device.type != "cuda":
            where = "CUDA or CPU" if self.reference else "CUDA"
            raise ValueError(f"{self.name} runs on {where}, not {y0.device}")
        if not self.takes(f, y):
            raise TypeError(
                f"{self.name} takes a rank-{self.rank} "
                f"{self.module.__name__} module and a state "
                f"{'pair ' if self.pair else ''}of "
                f"{_dtype_names(self.dtypes)}: got {type(f).__name__} of "
                f"shape {getattr(f, 'shape', None)} and "
                f"{_dtype_names(p.dtype for p in parts)}")
        n1 = f.shape[0]
        if n1 > self.max_n1:
            raise ValueError(f"n1 = {n1} exceeds the kernel's indices (n1 <= "
                             f"{self.max_n1})")
        if not self.pair and y0.dtype != f.dtype:
            raise TypeError(f"state dtype {y0.dtype} differs from the "
                            f"tendency's {f.dtype}")
        for p in parts:
            if p.dim() != 2 or tuple(p.shape) != (y0.shape[0], n1 - 1):
                raise ValueError(f"state shape {tuple(p.shape)}: expected "
                                 f"(B, {n1 - 1}), the same for hi and lo")
            if not p.is_contiguous() or p.device != y0.device:
                raise ValueError("state must be contiguous, a pair's parts "
                                 "on one device")
        check_steps(y0, dts, write_every)

    def launch(self, f, y, dts, write_every=0, kernel=None):
        """Advance the (B, n) state ``y`` (a (hi, lo) pair for a
        double-float family) by ``len(dts)`` RK4 steps of the tendency
        module ``f`` in one launch; ``dts`` (n_steps,) float64 on the
        state's device.  ``kernel`` (one of the family's ``kernels``)
        forces a kernel, as the checks that hold the kernels
        bit for bit do; by default the launch plan chooses
        (:func:`plan_tables`).

        Returns ``(y_final, records)`` (pairs for a pair), records
        (n_steps // write_every, B, n) holding the state after every
        ``write_every`` steps.  ``y`` is not modified.  A CPU state runs
        the family's plain ``reference`` (or raises where it has none); a
        CUDA state launches a kernel or raises (``RuntimeError`` for a
        tendency that fits none)."""
        y0 = y[0] if isinstance(y, tuple) else y
        if y0.device.type == "cpu" and self.reference is not None:
            return self.reference(f, y, dts, write_every)
        self.check(f, y, dts, write_every)
        kernel, tables = plan_tables(f, self, kernel, y0.dtype, y0.device,
                                     batch=y0.shape[0])
        return self.run(kernel, tables, f.shape[0], y, dts, write_every)


def _k1_sizes(coords, n1, groups, width, dtype):
    return (smem_bytes(n1, groups, width, dtype),
            streamed_smem_bytes(n1, groups, dtype),
            streamed_smem_bytes(n1, groups, dtype, inputs=1))


def _k1_tables(layout, kernel, dtype):
    records = resident_records if kernel == "resident" else streamed_records
    return (layout.lengths, None), (records(layout, dtype), None)


def _k1_occupancy(n1, groups, dtype, device):
    lib = _build.load_library()
    with torch.cuda.device(device):
        active = tuple(lib.qgs_rk4_streamed_max_clusters(
            n1, groups, int(dtype == torch.float64), c)
            for c in range(1, MAX_CLUSTER + 1))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    for err in active:
        if err < 0:
            raise RuntimeError(f"cannot read the streamed K1's clusters on "
                               f"{device}: CUDA error {-err} "
                               f"({_build.error_string(-err)})")
    return sms, active


def _k1_run(kernel, tables, n1, y, dts, write_every):
    global launches, launches_streamed, launches_clustered, launches_1buf
    # a cluster's kernel is ("streamed", c), its tables c * G groups
    # (plan_tables)
    kernel, cluster = kernel if isinstance(kernel, tuple) else (kernel, 1)
    blocks = -(-y.shape[0] // LANES)
    if kernel == "streamed":
        scratch = y.new_empty((blocks, 2, n1 - 1, LANES))
        out, records, launched = run_records(
            "rk4_streamed", _STREAMED_FNS[y.dtype], tables, n1, y, dts,
            write_every, scratch.data_ptr(), cluster)
        launches_streamed += launched
        launches_clustered += launched * (cluster > 1)
    elif kernel == "streamed_1buf":
        # y, the accumulator and the next stage input
        scratch = y.new_empty((blocks, 3, n1 - 1, LANES))
        out, records, launched = run_records(
            "rk4_streamed_1buf", _1BUF_FNS[y.dtype], tables, n1, y, dts,
            write_every, scratch.data_ptr())
        launches_streamed += launched
        launches_1buf += launched
    else:
        out, records, launched = run_records(
            "rk4_fused", _FNS[y.dtype], tables, n1, y, dts, write_every)
        launches += launched
    return out, records


# K1.  G = 8 for both kernels: on the H100 it ties G = 4 at B = 16384 in
# float64 and is the fastest of 1, 2, 4 and 8 at B = 4096 and 16384
# otherwise (PERF.md, Findings).  An index word holds j | k << 16.
K1 = KernelFamily("rk4_fused", Tendency, 3, (torch.float32, torch.float64),
                  False, 1 << 15, 8, _k1_sizes, _k1_tables, _k1_run,
                  fused_rk4_reference, occupancy=_k1_occupancy)


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
    :class:`RowGroups` (``rows``), its layouts' bytes in the order of
    the family's ``kernels`` (``sizes``, None past the family's
    ``max_n1``) and the kernel the route takes (``kernel``: one of them or
    ``None``, :func:`pick_kernel`); from the
    first launch of a kernel on (:func:`plan_tables`), the family's layout
    (``layout``) and that kernel's device tables (``tables``, kernel ->
    tuple of tensors in the launcher's order; ``(kernel, c)`` for a
    cluster's); from the first
    streamed launch of a family that clusters it, the card's
    ``occupancy`` (its SMs and clusters at each ``c``), and the last
    streamed launch's ``c`` (``cluster``)."""

    def __init__(self, f, family, dtype, device, groups, limit):
        self.coords, self.data, self.shape = f.coords, f.data, f.shape
        self.device, self.groups, self.limit = device, groups, limit
        self.rows = row_groups(f.coords, f.shape[0], groups)
        self.sizes = (family.sizes(f.coords, f.shape[0], groups,
                                   self.rows.width, dtype)
                      if f.shape[0] <= family.max_n1 else (None, None))
        self.kernel = pick_kernel(self.sizes, limit, family.kernels)
        self.layout = None
        self.tables = {}
        self.occupancy = None
        self.cluster = 1


def launch_plan(f, family, dtype, device, groups=None, limit=None):
    """The launch plan (a :class:`LaunchPlan`) of the tendency ``f`` for
    the kernel ``family`` (:data:`K1`, or
    :data:`~qgs_tpu_torch.ops.fused_df_rk4.DF`, of a rank-3 tendency;
    :data:`~qgs_tpu_torch.ops.fused_rk4_quartic.K5` of a rank-5 one) in
    ``dtype`` on ``device``, with ``groups`` row groups (by default the
    family's G; another G serves the checks of the layout) and ``limit``
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
    if groups is None:
        groups = family.groups
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


def plan_tables(f, family, kernel, dtype, device, groups=None, limit=None,
                batch=None, _cluster=None):
    """``(kernel, tables)`` of a launch of the tendency ``f`` (every
    launch's one path to its tables): ``kernel`` where it is forced, else
    its plan's choice (:func:`launch_plan`, looked up under the span
    ``qgs.layout``), and that kernel's device tables.  For the streamed
    kernel of a family that clusters it (``family.occupancy``), at the
    family's G, the plan also picks ``c`` for ``batch`` members
    (:func:`pick_cluster` over the card's occupancy, read once a plan into
    ``plan.occupancy``; ``_cluster`` forces it, as the checks that hold the
    clustered launches bit for bit do; kept as ``plan.cluster``), and ``c >
    1`` returns the kernel as ``(kernel, c)``, the one place the launcher
    takes ``c`` from, with the tables of a layout of ``c·G`` groups, block
    rank ``r`` of a cluster running groups ``r·G`` to ``r·G + G - 1``.  The
    plan's first launch of a kernel (at a ``c``) builds them (the family's
    layout once a plan and ``c``, under ``qgs.layout``) and uploads them
    (under ``qgs.layout_in``); every later one takes the stored tables and
    counts in :data:`plan_hits`.  Raises where the plan's choice is no
    kernel, or a forced ``c > 1`` where no cluster runs."""
    global plan_hits
    with span("qgs.layout"):
        plan = launch_plan(f, family, dtype, device, groups, limit)
        kernel = kernel or plan.kernel
        if kernel is None:
            raise no_kernel_fits(family.name, family.kernels, plan.sizes,
                                 plan.shape[0], plan.limit, plan.device)
        clustered = (kernel == "streamed" and family.occupancy is not None
                     and plan.groups == family.groups)
        cluster = _cluster
        if cluster is None:
            cluster = 1
            if clustered and batch:
                if plan.occupancy is None:
                    plan.occupancy = family.occupancy(
                        plan.shape[0], plan.groups, dtype, plan.device)
                cluster = pick_cluster(-(-batch // LANES), *plan.occupancy)
        elif cluster != 1 and not (clustered and 1 < cluster <= MAX_CLUSTER):
            raise ValueError(f"{family.name}'s {kernel} kernel at G = "
                             f"{plan.groups} takes no cluster of {cluster}")
        if clustered:
            plan.cluster = cluster
        key = kernel if cluster == 1 else (kernel, cluster)
        if key in plan.tables:
            plan_hits += 1
            return key, plan.tables[key]
        if cluster == 1:
            if plan.layout is None:
                plan.layout = family.layout(plan.coords, plan.data,
                                            plan.shape, plan.groups,
                                            plan.rows)
            layout = plan.layout
        else:
            layout = family.layout(plan.coords, plan.data, plan.shape,
                                   cluster * plan.groups, None)
        host = family.tables(layout, kernel, dtype)
    with span("qgs.layout_in"):
        tables = plan.tables[key] = tuple(
            torch.as_tensor(a, dtype=t, device=plan.device) for a, t in host)
    return key, tables


def fused_rk4(f, y, dts, write_every=0):
    """Advance the (B, n) state ``y`` by ``len(dts)`` RK4 steps of the
    rank-3 tendency module ``f`` (a
    :class:`~qgs_tpu_torch.ops.contraction.Tendency`) in one launch of K1
    (:meth:`KernelFamily.launch` of :data:`K1`); ``dts`` (n_steps,)
    float64 on ``y``'s device.  The tendency's launch plan decides which
    kernel runs.

    Returns ``(y_final, records)``, records (n_steps // write_every, B, n)
    holding the state after every ``write_every`` steps.  ``y`` is not
    modified.  A CPU state runs :func:`fused_rk4_reference`; a CUDA state
    launches a kernel or raises (``RuntimeError`` for a tendency that fits
    neither kernel)."""
    return K1.launch(f, y, dts, write_every)
