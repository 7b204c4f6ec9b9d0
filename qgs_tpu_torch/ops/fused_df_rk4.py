"""
Fused double-float RK4 kernel (K2)
==================================

K2's family (:data:`DF`) for the fused RK4 kernels' one seam
(:class:`~qgs_tpu_torch.ops.fused_rk4.KernelFamily`): the CUDA kernels
``csrc/rk4_df_fused.cu`` (resident) and ``csrc/rk4_df_streamed.cu``
(streamed), the Hopper port of the TPU kernel ``make_pallas_df_rk4``
(``qgs_tpu/ops/pallas_kernels.py:107``).  They advance a batch of
double-float states ``(y_hi, y_lo)`` by ``len(dts)`` classical RK4 steps
of a rank-3 quadratic tendency in one launch, step ``s`` of size
``dts[s]``, and record the state every ``write_every`` steps, over K1's
layout (:func:`~qgs_tpu_torch.ops.fused_rk4.group_layout`).

* :func:`fused_df_rk4` launches a kernel for a CUDA state and counts the
  launch in :data:`launches` (the streamed kernel's in
  :data:`launches_streamed`).  For a CPU state it runs the plain version
  instead (the kernels have no CPU build).
* :func:`fused_df_rk4_reference` is the plain PyTorch version: a step loop
  of :func:`qgs_tpu_torch.ops.twofloat.make_df_rk4_step_dynamic` over the
  plain contraction :class:`~qgs_tpu_torch.ops.twofloat.DfTendency`.
* :func:`df_group_tendency` evaluates the double-float tendency through
  the layout in plain PyTorch, in the kernels' summation order;
  :func:`df_streamed_tendency` through the streamed kernel's records
  (:func:`df_streamed_records`).
* :func:`df_smem_bytes` and :func:`df_streamed_smem_bytes` are the two
  kernels' shared memory, the formulas of the launch plan's choice.
"""

from __future__ import annotations

import numpy as np
import torch

from qgs_tpu_torch.ops import _build
from qgs_tpu_torch.ops.fused_rk4 import (CHUNK, LANES, LAST, TILE,
                                         GroupLayout, KernelFamily,
                                         pack_records, raise_on_error,
                                         ring_bytes, start_run)
from qgs_tpu_torch.ops.twofloat import (DfTendency, df_add, df_mul,
                                        make_df_rk4_step_dynamic, split_values)

launches = 0             # resident K2 launches in this process
launches_streamed = 0    # streamed K2 launches in this process

CHUNK_BYTES = 48         # a chunk of two entries in shared memory (Chunk)


def df_smem_bytes(n1, groups, width):
    """Shared memory of one block of the kernel for a layout of ``groups``
    tables of ``width`` records (``width // CHUNK`` chunks) over a tensor
    of first dimension ``n1``: the chunks, then five state rows of ``n1``
    or ``n`` (hi, lo) lanes (``df_smem_bytes`` of ``csrc/rk4_df_fused.cu``,
    which ``chip_smoke.py`` holds this against)."""
    n1 = int(n1)
    return (CHUNK_BYTES * groups * (width // CHUNK)
            + 8 * (3 * (n1 - 1) + 2 * n1) * LANES)


def df_streamed_smem_bytes(n1, groups):
    """Shared memory of one block of the streamed kernel over a tensor of
    first dimension ``n1``: the rings, then the two stage inputs of ``n1``
    (hi, lo) rows of :data:`~qgs_tpu_torch.ops.fused_rk4.LANES` lanes
    (``df_streamed_smem_bytes`` of ``csrc/rk4_df_streamed.cu``, which
    ``chip_smoke.py`` holds this against).  The records stay in device
    memory."""
    return ring_bytes(groups) + 8 * 2 * int(n1) * LANES


def df_streamed_records(layout):
    """The streamed kernel's records of ``layout``
    (:func:`~qgs_tpu_torch.ops.fused_rk4.pack_records`), each value as its
    float32 (hi, lo) split, hi in the third word and lo in the fourth."""
    vhi, vlo = split_values(layout.vals)
    return pack_records(layout.jk, layout.ctl,
                        np.stack([vhi.view("<i4"), vlo.view("<i4")], axis=-1),
                        TILE)


def _df_sizes(coords, n1, groups, width, dtype):
    if dtype != torch.float32:
        raise TypeError(f"dtype {dtype}: the kernel takes float32 (hi, lo) "
                        "pairs")
    return df_smem_bytes(n1, groups, width), df_streamed_smem_bytes(n1, groups)


def _df_tables(layout, kernel, dtype):
    if kernel == "streamed":
        return (layout.lengths, None), (df_streamed_records(layout), None)
    vhi, vlo = split_values(layout.vals)
    return ((layout.lengths, None), (layout.jk, None), (layout.ctl, None),
            (vhi, None), (vlo, None))


def df_streamed_tendency(recs, lengths, x_hi, x_lo):
    """The double-float tendency of the (B, n) pair ``(x_hi, x_lo)``
    through the streamed kernel's records ``recs``
    (:func:`df_streamed_records`) and the groups' ``lengths``, in plain
    PyTorch: the (hi, lo) values read from the records' words, the
    entries summed in the kernel's order (:func:`df_group_tendency`)."""
    recs = np.ascontiguousarray(recs, np.int32)
    split = tuple(np.ascontiguousarray(recs[..., w]).view("<f4")
                  for w in (2, 3))
    layout = GroupLayout(recs[..., 0], recs[..., 1], None,
                         np.asarray(lengths), None)
    return df_group_tendency(layout, x_hi, x_lo, split=split)


def fused_df_rk4_reference(f, y_hi, y_lo, dts, write_every=0):
    """Plain PyTorch version of :func:`fused_df_rk4`: ``((y_hi, y_lo),
    (rec_hi, rec_lo))`` with records (len(dts) // write_every, B, n), the
    state after every ``write_every`` steps (empty for ``write_every ==
    0``)."""
    step = make_df_rk4_step_dynamic(f)
    y = (y_hi, y_lo)
    recs = []
    for s, dt in enumerate(torch.as_tensor(dts).tolist()):
        y = step(y, 0., dt)
        if write_every and (s + 1) % write_every == 0:
            recs.append(y)
    if recs:
        return y, tuple(torch.stack(part) for part in zip(*recs))
    empty = y_hi.new_empty((0,) + tuple(y_hi.shape))
    return y, (empty, empty.clone())


def _where(mask, a, b):
    return tuple(torch.where(mask, p, q) for p, q in zip(a, b))


def df_group_tendency(layout, x_hi, x_lo, split=None):
    """The double-float tendency of the (B, n) pair ``(x_hi, x_lo)``
    through ``layout`` (a :class:`~qgs_tpu_torch.ops.fused_rk4.GroupLayout`),
    in plain PyTorch and in the kernel's order: each entry's term ``(v *
    xx[j]) * xx[k]``, slot ``s`` of each chunk of a row added in order into
    partial sum ``s`` (from (0, 0)), the two partial sums added at the
    row's end.  The products by ``xx[0] = (1, 0)`` are done, as the
    kernel does them.  The values are ``split``, a (hi, lo) pair of
    float32 arrays shaped as the tables, else the split of
    ``layout.vals``."""
    if split is None:
        split = split_values(layout.vals)
    dev = x_hi.device
    one = torch.ones_like(x_hi[:, :1])
    xx = (torch.cat([one, x_hi], dim=1),
          torch.cat([torch.zeros_like(one), x_lo], dim=1))
    out = (torch.zeros_like(x_hi), torch.zeros_like(x_lo))
    for g, length in enumerate(layout.lengths.tolist()):
        if length == 0:
            continue
        vhi, vlo = (torch.as_tensor(v[g, :length], device=dev)
                    for v in split)
        jk = torch.as_tensor(layout.jk[g, :length], device=dev)
        term = (vhi.expand(x_hi.shape[0], -1), vlo.expand(x_hi.shape[0], -1))
        for idx in (jk & 0xffff, jk >> 16):
            term = df_mul(term, (xx[0][:, idx], xx[1][:, idx]))
        # the group's rows side by side: each row's first record and chunk
        # count; chunk c of every row that has one is added at once
        ctl = layout.ctl[g, :length]
        ends = (np.flatnonzero(ctl[::CHUNK] & LAST) + 1) * CHUNK
        starts = np.concatenate([[0], ends[:-1]])
        chunks = (ends - starts) // CHUNK
        parts = [(torch.zeros_like(x_hi[:, :len(starts)]),) * 2] * CHUNK
        for c in range(int(chunks.max())):
            live = torch.as_tensor(c < chunks, device=dev)
            at = torch.as_tensor(np.where(c < chunks, starts + c * CHUNK, 0),
                                 device=dev)
            for s in range(CHUNK):
                new = df_add(parts[s], (term[0][:, at + s],
                                        term[1][:, at + s]))
                parts[s] = _where(live, new, parts[s])
        rows = torch.as_tensor(ctl[starts] & (LAST - 1), device=dev)
        for o, part in zip(out, df_add(parts[0], parts[1])):
            o[:, rows] = part
    return out


def _df_run(kernel, tables, n1, y, dts, write_every):
    global launches, launches_streamed
    (out_hi, rec_hi), (out_lo, rec_lo) = (start_run(p, dts.numel(),
                                                    write_every) for p in y)
    B, n_steps = out_hi.shape[0], dts.numel()
    if B == 0 or n_steps == 0:
        return (out_hi, out_lo), (rec_hi, rec_lo)
    dev = out_hi.device
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel == "streamed":
        lengths, recs = tables
        scratch = out_hi.new_empty((-(-B // LANES), 3, n1 - 1, LANES, 2))
        with torch.cuda.device(dev):
            err = lib.qgs_rk4_df_streamed(
                recs.data_ptr(), lengths.data_ptr(), recs.shape[0],
                recs.shape[1], n1, out_hi.data_ptr(), out_lo.data_ptr(), B,
                dts.data_ptr(), n_steps, write_every, rec_hi.data_ptr(),
                rec_lo.data_ptr(), scratch.data_ptr(), stream)
        raise_on_error(err, "rk4_df_streamed")
        launches_streamed += 1
        return (out_hi, out_lo), (rec_hi, rec_lo)
    lengths, jk, ctl, vhi, vlo = tables
    with torch.cuda.device(dev):
        err = lib.qgs_rk4_df_fused(
            jk.data_ptr(), ctl.data_ptr(), vhi.data_ptr(), vlo.data_ptr(),
            lengths.data_ptr(), jk.shape[0], jk.shape[1], n1,
            out_hi.data_ptr(), out_lo.data_ptr(), B, dts.data_ptr(), n_steps,
            write_every, rec_hi.data_ptr(), rec_lo.data_ptr(), stream)
    raise_on_error(err, "rk4_df_fused")
    launches += 1
    return (out_hi, out_lo), (rec_hi, rec_lo)


# K2, at K1's G of 8: on the H100 the fastest of 1, 2, 4 and 8 at B = 4096
# and 16384 (PERF.md, Findings)
DF = KernelFamily("rk4_df_fused", DfTendency, 3, (torch.float32,), True,
                  1 << 15, 8, _df_sizes, _df_tables, _df_run,
                  lambda f, y, dts, write_every: fused_df_rk4_reference(
                      f, *y, dts, write_every))


def fused_df_rk4(f, y_hi, y_lo, dts, write_every=0):
    """Advance the (B, n) double-float state ``(y_hi, y_lo)`` (float32
    each) by ``len(dts)`` RK4 steps of the tendency module ``f`` (a
    :class:`~qgs_tpu_torch.ops.twofloat.DfTendency`) in one launch of K2
    (:meth:`~qgs_tpu_torch.ops.fused_rk4.KernelFamily.launch` of
    :data:`DF`); ``dts`` (n_steps,) float64 on the state's device.  The
    tendency's launch plan decides which kernel runs.

    Returns ``((y_hi, y_lo), (rec_hi, rec_lo))``, records (n_steps //
    write_every, B, n) holding the state after every ``write_every`` steps.
    The inputs are not modified.  A CPU state runs
    :func:`fused_df_rk4_reference`; a CUDA state launches a kernel or
    raises (``RuntimeError`` for a tendency that fits neither kernel)."""
    return DF.launch(f, (y_hi, y_lo), dts, write_every)
