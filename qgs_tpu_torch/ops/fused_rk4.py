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
* :func:`csr_layout` is the kernel's tensor layout: the COO entries sorted
  by output row, with CSR row offsets.
"""

from __future__ import annotations

import numpy as np
import torch

from qgs_tpu_torch.ops import _build

launches = 0             # kernel launches in this process (plain runs excluded)

_FNS = {torch.float32: "qgs_rk4_fused_f32", torch.float64: "qgs_rk4_fused_f64"}


def csr_layout(coords, data, shape):
    """Row-sorted entries of a rank-3 COO tensor for the kernel.

    Entries of output row 0 (the dummy) are dropped; the others keep their
    COO order within a row.  Returns ``(row_ptr (n1 + 1,) int32,
    jk (nnz,) int32 holding j | k << 16, vals (nnz,) float64)``."""
    coords = np.asarray(coords, np.int64)
    data = np.asarray(data, np.float64)
    n1 = int(shape[0])
    if len(shape) != 3:
        raise NotImplementedError("the fused RK4 kernel takes rank-3 tensors")
    if n1 > 1 << 15:
        raise ValueError(f"n1 = {n1} exceeds the kernel's 15-bit indices")
    keep = coords[0] != 0
    order = np.argsort(coords[0][keep], kind="stable")
    rows = coords[0][keep][order]
    j, k = coords[1][keep][order], coords[2][keep][order]
    row_ptr = np.zeros(n1 + 1, np.int32)
    row_ptr[1:] = np.cumsum(np.bincount(rows, minlength=n1))
    jk = (j | (k << 16)).astype(np.int32)
    return row_ptr, jk, data[keep][order]


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


def device_layout(f, device):
    """:func:`csr_layout` of the module ``f``'s tensor: ``row_ptr`` and
    ``jk`` on ``device``, the values as float64 on the host."""
    row_ptr, jk, vals = csr_layout(f.coords, f.data, f.shape)
    return (torch.as_tensor(row_ptr, device=device),
            torch.as_tensor(jk, device=device), vals)


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


def fused_rk4(f, y, dts, write_every=0):
    """Advance the (B, n) state ``y`` by ``len(dts)`` RK4 steps of the
    tendency module ``f`` (a :class:`~qgs_tpu_torch.ops.contraction.Tendency`)
    in one kernel launch; ``dts`` (n_steps,) float64 on ``y``'s device.

    Returns ``(y_final, records)``, records (n_steps // write_every, B, n)
    holding the state after every ``write_every`` steps.  ``y`` is not
    modified.  A CPU state runs :func:`fused_rk4_reference`; a CUDA state
    launches the kernel or raises."""
    global launches
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

    row_ptr, jk, vals = device_layout(f, y.device)
    vals = torch.as_tensor(vals, dtype=y.dtype, device=y.device)
    lib = _build.load_library()
    with torch.cuda.device(y.device):
        err = getattr(lib, _FNS[y.dtype])(
            row_ptr.data_ptr(), jk.data_ptr(), vals.data_ptr(), f.shape[0],
            jk.numel(), out.data_ptr(), B, dts.data_ptr(), n_steps,
            write_every, records.data_ptr(),
            torch.cuda.current_stream(y.device).cuda_stream)
    raise_on_error(err, "rk4_fused")
    launches += 1
    return out, records
