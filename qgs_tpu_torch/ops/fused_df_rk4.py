"""
Fused double-float RK4 kernel
=============================

Wrapper of the CUDA kernel ``csrc/rk4_df_fused.cu``, the Hopper port of the
TPU kernel ``make_pallas_df_rk4`` (``qgs_tpu/ops/pallas_kernels.py:107``):
it advances a batch of double-float states ``(y_hi, y_lo)`` by ``len(dts)``
classical RK4 steps of a rank-3 quadratic tendency in one launch, step ``s``
of size ``dts[s]``, and records the state every ``write_every`` steps.

* :func:`fused_df_rk4` launches the kernel for a CUDA state and counts the
  launch in :data:`launches`.  For a CPU state it runs the plain version
  instead (the kernel has no CPU build).
* :func:`fused_df_rk4_reference` is the plain PyTorch version: a step loop
  of :func:`qgs_tpu_torch.ops.twofloat.make_df_rk4_step_dynamic` over the
  plain contraction :class:`~qgs_tpu_torch.ops.twofloat.DfTendency`.
"""

from __future__ import annotations

import torch

from qgs_tpu_torch.ops import _build
from qgs_tpu_torch.ops.fused_rk4 import (check_steps, device_layout,
                                         raise_on_error, start_run)
from qgs_tpu_torch.ops.twofloat import make_df_rk4_step_dynamic, split_values

launches = 0             # kernel launches in this process (plain runs excluded)


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


def _check(f, y_hi, y_lo, dts, write_every):
    if not hasattr(f, "coords"):
        raise TypeError("fused_df_rk4 needs a DfTendency module (it carries "
                        "the rank-3 tensor the kernel runs)")
    n = f.shape[0] - 1
    for name, y in (("y_hi", y_hi), ("y_lo", y_lo)):
        if y.dtype != torch.float32:
            raise TypeError(f"{name} dtype {y.dtype}: the kernel takes "
                            "float32 (hi, lo) pairs")
        if y.dim() != 2 or y.shape[1] != n or y.shape != y_hi.shape:
            raise ValueError(f"{name} shape {tuple(y.shape)}: expected (B, "
                             f"{n}), the same for hi and lo")
        if not y.is_contiguous() or y.device != y_hi.device:
            raise ValueError(f"{name} must be contiguous and on y_hi's "
                             "device")
    check_steps(y_hi, dts, write_every)


def fused_df_rk4(f, y_hi, y_lo, dts, write_every=0):
    """Advance the (B, n) double-float state ``(y_hi, y_lo)`` (float32
    each) by ``len(dts)`` RK4 steps of the tendency module ``f`` (a
    :class:`~qgs_tpu_torch.ops.twofloat.DfTendency`) in one kernel launch;
    ``dts`` (n_steps,) float64 on the state's device.

    Returns ``((y_hi, y_lo), (rec_hi, rec_lo))``, records (n_steps //
    write_every, B, n) holding the state after every ``write_every`` steps.
    The inputs are not modified.  A CPU state runs
    :func:`fused_df_rk4_reference`; a CUDA state launches the kernel or
    raises."""
    global launches
    if y_hi.device.type == "cpu":
        return fused_df_rk4_reference(f, y_hi, y_lo, dts, write_every)
    if y_hi.device.type != "cuda":
        raise ValueError(f"fused_df_rk4 runs on CUDA or CPU, not "
                         f"{y_hi.device}")
    _check(f, y_hi, y_lo, dts, write_every)
    B = y_hi.shape[0]
    n_steps = dts.numel()
    out_hi, rec_hi = start_run(y_hi, n_steps, write_every)
    out_lo, rec_lo = start_run(y_lo, n_steps, write_every)
    if B == 0 or n_steps == 0:
        return (out_hi, out_lo), (rec_hi, rec_lo)

    dev = y_hi.device
    row_ptr, jk, vals = device_layout(f, dev)
    vhi, vlo = (torch.as_tensor(v, device=dev) for v in split_values(vals))
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.qgs_rk4_df_fused(
            row_ptr.data_ptr(), jk.data_ptr(), vhi.data_ptr(), vlo.data_ptr(),
            f.shape[0], jk.numel(), out_hi.data_ptr(), out_lo.data_ptr(), B,
            dts.data_ptr(), n_steps, write_every, rec_hi.data_ptr(),
            rec_lo.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(err, "rk4_df_fused")
    launches += 1
    return (out_hi, out_lo), (rec_hi, rec_lo)
