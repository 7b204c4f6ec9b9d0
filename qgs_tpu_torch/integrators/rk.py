"""
Runge-Kutta integration (device compute path)
=============================================

Counterpart of :mod:`qgs_tpu.integrators.rk` for the plain trajectory
integration: explicit Runge-Kutta steps for any Butcher tableau, over a
batch of states (B, ndim), in the tendency's dtype
(:func:`integrate_runge_kutta`) or in double-float arithmetic
(:func:`integrate_runge_kutta_df`).

* The time grid reproduces the reference: ``concat(arange(t0, t, dt), [t])``,
  each step taking its own ``np.diff`` of the grid (the last one possibly
  shorter), reversed for backward runs.  With ``write_steps = w`` the
  recorded points are ``time[::w]`` plus the final point.
* The JAX package's ``lax.scan`` over record chunks becomes a step loop that
  keeps only the recorded states.
* Routing: classical RK4 on a CUDA state runs the whole loop in one
  launch of a fused kernel where one fits: :func:`fused_route` returns the
  kernel family (:class:`~qgs_tpu_torch.ops.fused_rk4.KernelFamily`) that
  takes the tendency and whose launch plan has a kernel, and the loop
  launches through it.  A rank-3
  :class:`~qgs_tpu_torch.ops.contraction.Tendency` in float64 or float32
  goes to K1 (:data:`~qgs_tpu_torch.ops.fused_rk4.K1`): its resident kernel
  when the tensor's records and the state fit one block's shared memory on
  that card, else its streamed kernel, which keeps the records in device
  memory and only the two stage inputs in shared memory (on an H100 up to
  ndim 421 in float64, 843 in float32).  A rank-3
  :class:`~qgs_tpu_torch.ops.twofloat.DfTendency` on a CUDA pair goes to
  K2 (:data:`~qgs_tpu_torch.ops.fused_df_rk4.DF`; the streamed kernel up
  to ndim 421), and a rank-5 ``Tendency`` in float64 or float32 to K5
  (:data:`~qgs_tpu_torch.ops.fused_rk4_quartic.K5`) when its records and
  the state fit one block's shared memory.  Every other case (the CPU,
  other tableaux, rank 5 in double-float, tendency functions that carry
  no tensor, models past the kernels' limits) runs the step loop with
  plain tensor operations.  Under a profiler, :func:`integrate_runge_kutta`
  marks the state's and the time grid's uploads with the span
  ``qgs.state_in`` and the kernel's choice with ``qgs.route``
  (:func:`~qgs_tpu_torch.utils.profiling.span`); the plain step loop
  counts its steps in :data:`plain_steps`.
* The coupled (trajectory, tangent) system: :func:`make_tgls_step` and
  :func:`integrate_runge_kutta_tgls` (the tangent through the materialized
  Jacobian, or a direct contraction), :func:`integrate_runge_kutta_tgls_df`
  in double-float.  These run the plain step loop.
* Device: an entry point runs on the tendency function's ``.device``, else
  on the device of a tensor ``ic``, else on ``device`` (default ``"cuda"``:
  without a card PyTorch raises; there is no CPU fallback).
* ``mesh=`` (:mod:`qgs_tpu_torch.parallel.mesh`): a batch that fills the
  mesh's ensemble axis is split over it, each shard integrated on its
  device by a copy of the tendency there (one kernel launch a shard, or
  one step loop stepping every shard in turn), and the records
  concatenated on the mesh's first device
  (:func:`~qgs_tpu_torch.parallel.mesh.map_shards`).  Each
  trajectory's arithmetic does not depend on the batch, so the result
  equals the unsplit one.
"""

from __future__ import annotations

import numpy as np
import torch

from qgs_tpu_torch.ops import fused_df_rk4 as _fused_df
from qgs_tpu_torch.ops import fused_rk4 as _fused
from qgs_tpu_torch.ops import fused_rk4_quartic as _quartic
from qgs_tpu_torch.ops.contraction import _with_dummy
from qgs_tpu_torch.ops.twofloat import (
    DfTangent, DfTendency, df_from_f64, df_to_f64, make_df_rk4_step_dynamic,
    make_df_rk_step_dynamic, make_df_tgls_rk4_step_dynamic,
    make_df_tgls_rk_step_dynamic,
)
from qgs_tpu_torch.parallel.mesh import map_shards
from qgs_tpu_torch.utils.profiling import span

plain_steps = 0     # steps of the plain step loop run in this process (a
                    # step of every shard at once counts once)

# the fused kernels' families, each taking its own tendencies and states
_FAMILIES = (_fused.K1, _fused_df.DF, _quartic.K5)


def rk4_tableau(dtype=torch.float64):
    """The classical RK4 Butcher tableau (reference default), float64 NumPy
    arrays.  ``dtype`` is accepted for the JAX package's signature and, as
    there, changes nothing: a step runs in its state's dtype."""
    c = np.array([0., 0.5, 0.5, 1.])
    b = np.array([1. / 6, 1. / 3, 1. / 3, 1. / 6])
    a = np.zeros((4, 4))
    a[1, 0] = 0.5
    a[2, 1] = 0.5
    a[3, 2] = 1.
    return a, b, c


def rk2_tableau(dtype=torch.float64):
    """Heun's second-order method (``dtype`` as in :func:`rk4_tableau`)."""
    c = np.array([0., 1.])
    b = np.array([0.5, 0.5])
    a = np.zeros((2, 2))
    a[1, 0] = 1.
    return a, b, c


def merge_tableau(a=None, b=None, c=None, current=None):
    """Merge partially-specified Butcher coefficients into a full
    ``(a, b, c)`` tableau: unspecified coefficients fall back to ``current``
    and then to the RK4 defaults.  Returns ``None`` when nothing is
    specified and there is no current tableau."""
    if a is None and b is None and c is None and current is None:
        return None
    base = current if current is not None else rk4_tableau()
    return (np.asarray(a) if a is not None else np.asarray(base[0]),
            np.asarray(b) if b is not None else np.asarray(base[1]),
            np.asarray(c) if c is not None else np.asarray(base[2]))


def time_grid(t0, t, dt):
    """Reference-compatible integration time grid (host side)."""
    return np.concatenate((np.arange(t0, t, dt), np.full((1,), t)))


def _record_indices(n_points, write_steps):
    """Indices into the time grid that get recorded (host side)."""
    idx = list(range(0, n_points, write_steps))
    if idx[-1] != n_points - 1:
        idx.append(n_points - 1)
    return np.array(idx)


def _is_rk4(a, b, c):
    return all(np.array_equal(np.asarray(x), y)
               for x, y in zip((a, b, c), rk4_tableau()))


def make_rk_step(f, a, b, c, dtype=torch.float64):
    """Single-step function ``step(y, tt, dt) -> y_new`` for the explicit
    tableau (a, b, c).  ``dt`` is cast to the state dtype before it scales
    a stage (as in the JAX package: float32 states stay float32, whatever
    ``dtype``, which is accepted for the JAX package's signature)."""
    s = len(b)
    a = np.asarray(a)
    b = np.asarray(b)
    c = np.asarray(c)

    def step(y, tt, dt):
        k = []
        for i in range(s):
            y_s = y
            for l in range(i):
                if a[i, l] != 0.0:
                    y_s = y_s + _fused.scaled_dt(dt, a[i, l], y.dtype) * k[l]
            k.append(f(tt + float(c[i]) * dt, y_s))
        y_new = y
        for i in range(s):
            if b[i] != 0.0:
                y_new = y_new + _fused.scaled_dt(dt, b[i], y.dtype) * k[i]
        return y_new

    return step


def make_tgls_step(f, fjac, a, b, c, adjoint=False, inverse=False,
                   boundary=None, dtype=torch.float64, tangent=None):
    """Single step ``step((y, dm), tt, dt) -> (y', dm')`` of the coupled
    (trajectory, tangent) system, ``dm`` a (B, ndim, n_tg) block propagated
    by ``d(dm)/dt = +-J(x) dm`` (``J^T`` for the adjoint, ``-`` for the
    inverse) plus an optional inhomogeneous ``boundary(t, x)`` term (ref
    ``integrate.py:556-614``).  The stages are :func:`make_rk_step`'s.

    Without ``tangent`` the Jacobian ``fjac(t, y_s)`` is materialized; with
    it, ``tangent(xx, dm)`` (a :class:`~qgs_tpu_torch.ops.contraction.Tangent`
    carrying the adjoint/inverse transform itself) is applied to ``xx = [1,
    y_s]``.  ``dtype`` is :func:`make_rk_step`'s."""
    s = len(b)
    a = np.asarray(a)
    b = np.asarray(b)
    c = np.asarray(c)

    def tangent_rhs(t, y_s, dm):
        if tangent is not None:
            hom = tangent(_with_dummy(y_s), dm)
        else:
            J = fjac(t, y_s)                             # (B, n, n)
            hom = (J.transpose(-1, -2) if adjoint else J) @ dm
            if inverse:
                hom = -hom
        if boundary is not None:
            hom = hom + boundary(t, y_s)
        return hom

    def step(carry, tt, dt):
        y, dm = carry
        k, km = [], []
        for i in range(s):
            y_s, dm_s = y, dm
            for l in range(i):
                if a[i, l] != 0.0:
                    h = _fused.scaled_dt(dt, a[i, l], y.dtype)
                    y_s = y_s + h * k[l]
                    dm_s = dm_s + h * km[l]
            ts = tt + float(c[i]) * dt
            k.append(f(ts, y_s))
            km.append(tangent_rhs(ts, y_s, dm_s))
        y_new, dm_new = y, dm
        for i in range(s):
            if b[i] != 0.0:
                h = _fused.scaled_dt(dt, b[i], y.dtype)
                y_new = y_new + h * k[i]
                dm_new = dm_new + h * km[i]
        return y_new, dm_new

    return step


def resolve_device(f, ic=None, device=None):
    """The device an entry point runs on: ``f``'s own ``.device`` when it
    has one, else the device of a tensor ``ic``, else ``device`` (default
    ``"cuda"``)."""
    dev = getattr(f, "device", None)
    if dev is None and torch.is_tensor(ic):
        dev = ic.device
    if dev is None:
        dev = "cuda" if device is None else device
    return torch.device(dev)


def infer_ndim(f, device=None):
    """The state dimension of a batched tendency function.  A module that
    carries its tensor (a :class:`~qgs_tpu_torch.ops.contraction.Tendency`
    or :class:`~qgs_tpu_torch.ops.twofloat.DfTendency`: a tuple ``.shape``
    of its COO tensor) gives ``shape[0] - 1`` without being called; a plain
    callable is probed with zero states of growing size until the output is
    consistent (ref ``qgs/integrators/integrate.py:131-143``), on the device
    that :func:`resolve_device` gives."""
    shape = getattr(f, "shape", None)
    if isinstance(shape, tuple):
        return int(shape[0]) - 1
    kw = dict(dtype=getattr(f, "dtype", torch.float64),
              device=resolve_device(f, None, device))
    for n in range(1, 513):
        try:
            m = int(f(0., torch.zeros((1, n), **kw)).shape[-1])
            if m == n or int(f(0., torch.zeros((1, m), **kw)).shape[-1]) == m:
                return m
        except (RuntimeError, IndexError, ValueError):
            continue
    raise ValueError("could not infer the model dimension from the "
                     "tendency function; pass an explicit ic")


def as_state(f, ic, device=None, dtype=None):
    """The initial condition as a contiguous 2-D tensor on the device that
    :func:`resolve_device` gives, in ``dtype``, else ``f``'s dtype, else
    its own (float64 for an array that is not floating point)."""
    dev = resolve_device(f, ic, device)
    if not torch.is_tensor(ic):
        ic = np.asarray(ic)
        if not np.issubdtype(ic.dtype, np.floating):
            ic = ic.astype(np.float64)
        ic = torch.as_tensor(ic)
    ic = ic.to(dtype=dtype or getattr(f, "dtype", ic.dtype), device=dev)
    return torch.atleast_2d(ic).contiguous()


def fused_route(f, y, tableau):
    """The kernel family that runs ``f`` on the state ``y`` (a (hi, lo)
    pair in double-float), or None for the plain step loop: classical RK4
    on a CUDA state, the family that takes the tendency module and the
    state (:meth:`~qgs_tpu_torch.ops.fused_rk4.KernelFamily.takes`: K1 a
    rank-3 ``Tendency`` in float64 or float32, K2 a rank-3 ``DfTendency``
    on a float32 pair, K5 a rank-5 ``Tendency`` in float64 or float32),
    where its launch plan has a kernel
    (:func:`~qgs_tpu_torch.ops.fused_rk4.launch_plan`, built at the first
    call and kept on ``f``, so that the launch reads the same choice: K1's
    resident kernel, its streamed one, or past that the streamed one's
    single-buffer variant).  Other tableaux, rank 5 in double-float, and
    models past the kernels' limits (on an H100 from ndim 844 in float64,
    1688 in float32 and 422 in twofloat; rank 5 past n1 = 256 or one
    block's shared memory) take the plain step loop, as the JAX package's
    integrator takes for every model."""
    y0 = y[0] if isinstance(y, tuple) else y
    if not (_is_rk4(*tableau) and y0.is_cuda):
        return None
    family = next((fam for fam in _FAMILIES if fam.takes(f, y)), None)
    if family is None:
        return None
    with span("qgs.route"):
        plan = _fused.launch_plan(f, family, y0.dtype, y0.device)
        return family if plan.kernel is not None else None


def _stack(recs):
    """Stack records along a new first axis, part by part (recursively)
    for tuples."""
    if isinstance(recs[0], tuple):
        return tuple(_stack(part) for part in zip(*recs))
    return torch.stack(recs)


def _step_loop(step, y, tts, dts, write_steps, record=lambda y: y):
    """Plain step loop: the records at steps 0, w, 2w, ... and the final
    step (the final state alone for w = 0), each passed through
    ``record``, stacked (part by part when a record is a tuple)."""
    global plain_steps
    n_steps = len(dts)
    recs = [record(y)] if write_steps > 0 else []
    for s in range(n_steps):
        y = step(y, float(tts[s]), float(dts[s]))
        plain_steps += 1
        if write_steps > 0 and (s + 1) % write_steps == 0:
            recs.append(record(y))
    if write_steps == 0 or n_steps % write_steps:
        recs.append(record(y))
    return _stack(recs)


def _assemble(y0, recs, final, n_steps, write_steps):
    """The step loop's records from a fused kernel's: the initial state,
    the kernel's records and, when it is not among them, the final one."""
    parts = [y0[None]] if write_steps > 0 else []
    parts.append(recs)
    if write_steps == 0 or n_steps % write_steps:
        parts.append(final[None])
    return torch.cat(parts)


def _step_loops(steps, ys, tts, dts, write_steps, record=lambda y: y):
    """:func:`_step_loop` of every shard ``ys[k]`` under ``steps[k]`` at
    once: step ``s`` of every shard before step ``s + 1`` of any, so that
    their devices work side by side.  Returns each shard's records."""
    def step(carries, tt, dt):
        return tuple(st(c, tt, dt) for st, c in zip(steps, carries))

    return list(_step_loop(step, tuple(ys), tts, dts, write_steps,
                           lambda cs: tuple(record(c) for c in cs)))


def _fused_records(family, f, y, dts, write_steps):
    """The same records from one launch of the kernel ``family``; a
    double-float pair's as float64."""
    y0 = y[0] if isinstance(y, tuple) else y
    with span("qgs.state_in"):
        dts_dev = torch.as_tensor(dts, dtype=torch.float64, device=y0.device)
    final, recs = family.launch(f, y, dts_dev, write_steps)
    if isinstance(y, tuple):
        y, recs, final = df_to_f64(y), df_to_f64(recs), df_to_f64(final)
    return _assemble(y, recs, final, len(dts), write_steps)


def _rk_records(fns, ys, tableau, tts, dts, write_steps):
    """Each shard's stacked records: one fused-kernel launch a shard, else
    one plain step loop over every shard."""
    family = fused_route(fns[0], ys[0], tableau)
    if family is not None:
        return [_fused_records(family, f, y, dts, write_steps)
                for f, y in zip(fns, ys)]
    return _step_loops([make_rk_step(f, *tableau) for f in fns], ys, tts,
                       dts, write_steps)


def _df_records(fns, ys, tableau, tts, dts, write_steps):
    """The same in double-float, from float64 shards, records float64."""
    ys = [df_from_f64(y) for y in ys]
    family = fused_route(fns[0], ys[0], tableau)
    if family is not None:
        return [_fused_records(family, f, y, dts, write_steps)
                for f, y in zip(fns, ys)]
    steps = [make_df_rk4_step_dynamic(f) if _is_rk4(*tableau)
             else make_df_rk_step_dynamic(f, *tableau) for f in fns]
    return _step_loops(steps, ys, tts, dts, write_steps, df_to_f64)


def _df_module(tensor, cls, ic, device):
    """``tensor`` itself when it is callable, else the COO tensor wrapped in
    ``cls`` (:class:`~qgs_tpu_torch.ops.twofloat.DfTendency` or
    :class:`~qgs_tpu_torch.ops.twofloat.DfTangent`) on the device that
    :func:`resolve_device` gives."""
    if callable(tensor):
        return tensor
    return cls(tensor.coords, tensor.data, tensor.shape,
               device=resolve_device(None, ic, device))


def _directed_grid(t0, t, dt, forward):
    """The time grid, and each step's start time and size in the direction
    of integration."""
    time = time_grid(t0, t, dt)
    directed = time if forward else time[::-1]
    return time, directed[:-1], np.diff(directed)


def _finish(time, recs, forward, write_steps, squeeze):
    """Record times and the (B, ndim, n_records) trajectory (the last
    state alone for write_steps = 0) from the stacked records."""
    traj = torch.movedim(recs, 0, -1)           # (B, ndim, n_records)
    if not forward:
        traj = traj.flip(-1)
    if write_steps > 0:
        rec = _record_indices(len(time), write_steps)
        rec_times = time[rec] if forward else time[::-1][rec][::-1]
    else:
        rec_times, traj = time[-1], traj[..., -1]
    return rec_times, (traj.squeeze() if squeeze else traj)


def integrate_runge_kutta(f, t0, t, dt, ic=None, forward=True, write_steps=1,
                          b=None, c=None, a=None, squeeze=True, device=None,
                          mesh=None):
    """Integrate dx/dt = f(t, x) over [t0, t] for a batch of initial
    conditions; returns ``(times, traj)`` with traj shaped (B, ndim,
    n_records) (squeezed), a tensor on the integration's device.

    ``f`` must be a *batched* tendency function (B, ndim) -> (B, ndim).  The
    integration runs in ``f``'s dtype (else ``ic``'s) and on the device that
    :func:`resolve_device` gives (``ic`` is cast and moved there).  With
    ``ic=None`` the state dimension is probed from ``f`` and a zero initial
    condition is used.  With a ``mesh`` (:mod:`qgs_tpu_torch.parallel.mesh`)
    whose ensemble axis the batch fills, each shard runs on its device (one
    kernel launch a shard on the fused route) and the trajectory ends up on
    the mesh's first device.
    """
    if ic is None:
        ic = np.zeros((1, infer_ndim(f, device)))
    with span("qgs.state_in"):
        y = as_state(f, ic, device)
    if a is None and b is None and c is None:
        a, b, c = rk4_tableau()
    time, tts, dts = _directed_grid(t0, t, dt, forward)
    recs = map_shards(mesh, y, f, lambda fns, ys: _rk_records(
        fns, ys, (a, b, c), tts, dts, write_steps), dim=1)
    return _finish(time, recs, forward, write_steps, squeeze)


def integrate_runge_kutta_df(tensor, t0, t, dt, ic, forward=True,
                             write_steps=1, squeeze=True, a=None, b=None,
                             c=None, device=None, mesh=None):
    """Integrate the model in double-float (pairs of float32) arithmetic:
    about 48-bit-mantissa trajectories, with the time grid, record and
    ``mesh`` semantics of :func:`integrate_runge_kutta`.  Counterpart of the
    JAX package's ``integrate_runge_kutta_df``.

    ``tensor`` is the COO tendency tensor (``QgsTensor.tensor``), wrapped
    once in a :class:`~qgs_tpu_torch.ops.twofloat.DfTendency` on the
    integration's device; or a ``DfTendency`` itself, or any ``f(y_hi,
    y_lo) -> (f_hi, f_lo)`` on (B, ndim) pairs.  ``ic`` is float64 (B,
    ndim) and the returned trajectory is float64, on the device that
    :func:`resolve_device` gives.  Any explicit Butcher tableau is accepted
    (default RK4); an implicit one raises ``ValueError``.  Classical RK4 of a
    rank-3 ``DfTendency`` on a CUDA state runs in one launch of the fused
    kernel; every other case runs the plain double-float step loop.
    """
    f = _df_module(tensor, DfTendency, ic, device)
    y = as_state(f, ic, device, torch.float64)
    if a is None and b is None and c is None:
        a, b, c = rk4_tableau()
    time, tts, dts = _directed_grid(t0, t, dt, forward)
    recs = map_shards(mesh, y, f, lambda fns, ys: _df_records(
        fns, ys, (a, b, c), tts, dts, write_steps), dim=1)
    return _finish(time, recs, forward, write_steps, squeeze)


def normalize_tg_ic(tg_ic, B, n):
    """A tangent initial condition as the (B, n, n_tg) block: 1-D is one
    perturbation broadcast over the batch; 2-D is per-trajectory vectors
    when shaped (B, n), else an (n_tg, n) matrix shared across the batch;
    3-D with a transposed middle axis is swapped (the JAX package's
    ``_normalize_tg_ic``)."""
    tg = tg_ic if torch.is_tensor(tg_ic) else torch.as_tensor(
        np.asarray(tg_ic))
    if tg.dim() == 1:
        tg = tg[None, :, None].expand(B, n, 1)
    elif tg.dim() == 2:
        if tg.shape[0] == B and tg.shape[1] == n:
            tg = tg[:, :, None]
        else:
            tg = tg.T[None].expand(B, n, tg.shape[0])
    elif tg.dim() == 3 and tg.shape[1] != n:
        tg = tg.transpose(1, 2)
    return tg


def _tgls_start(f, ic, tg_ic, device, dtype=None):
    """The state (B, n) and the tangent block (B, n, n_tg), in the state's
    dtype and on its device."""
    y = as_state(f, ic, device, dtype)
    tg = normalize_tg_ic(tg_ic, *y.shape).to(y).contiguous()
    return y, tg


def _finish_tgls(time, recs, forward, write_steps):
    """Record times, and the trajectory and fundamental matrices (B, ndim,
    [n_tg,] n_records), squeezed, from the stacked ``(y, dm)`` records."""
    rec_times, traj = _finish(time, recs[0], forward, write_steps, True)
    _, fmat = _finish(time, recs[1], forward, write_steps, True)
    return rec_times, traj, fmat


def integrate_runge_kutta_tgls(f, fjac, t0, t, dt, ic, tg_ic, forward=True,
                               adjoint=False, inverse=False, boundary=None,
                               write_steps=1, b=None, c=None, a=None,
                               device=None, mesh=None):
    """Integrate the coupled (trajectory, tangent-linear) system over [t0,
    t] with the Jacobian ``fjac`` materialized at every stage.

    ``tg_ic`` may be (ndim,), (B, ndim), (n_tg, ndim) or (B, ndim, n_tg)
    (see :func:`normalize_tg_ic`): a fundamental matrix of tangent vectors
    is propagated.  Returns ``(times, traj, fmatrix)`` with the reference
    shapes (B, ndim, n_records) and (B, ndim, n_tg, n_records), squeezed, as
    tensors on the device that :func:`resolve_device` gives, in ``f``'s
    dtype (else ``ic``'s).  With a ``mesh`` the states and their tangent
    blocks are split over it together, as in :func:`integrate_runge_kutta`
    (``boundary`` is called with each shard as it is)."""
    y, tg = _tgls_start(f, ic, tg_ic, device)
    if a is None and b is None and c is None:
        a, b, c = rk4_tableau()
    time, tts, dts = _directed_grid(t0, t, dt, forward)

    def records(fns, carries):
        steps = [make_tgls_step(fk, jk, a, b, c, adjoint=adjoint,
                                inverse=inverse, boundary=boundary)
                 for fk, jk in fns]
        return _step_loops(steps, carries, tts, dts, write_steps)

    recs = map_shards(mesh, (y, tg), (f, fjac), records, dim=1)
    return _finish_tgls(time, recs, forward, write_steps)


def integrate_runge_kutta_tgls_df(tensor, jtensor, t0, t, dt, ic, tg_ic,
                                  forward=True, adjoint=False, inverse=False,
                                  write_steps=1, mesh=None, a=None, b=None,
                                  c=None, device=None):
    """Integrate the coupled (trajectory, tangent) system in double-float
    arithmetic, with the time grid, record, shape and ``mesh`` semantics of
    :func:`integrate_runge_kutta_tgls`.  Counterpart of the JAX package's
    ``integrate_runge_kutta_tgls_df``.

    ``tensor`` and ``jtensor`` are the COO tendency and Jacobian tensors
    (``QgsTensor.tensor``, ``.jacobian_tensor``), wrapped once in a
    :class:`~qgs_tpu_torch.ops.twofloat.DfTendency` and a
    :class:`~qgs_tpu_torch.ops.twofloat.DfTangent` on the integration's
    device, or those modules themselves; ``adjoint`` and ``inverse``
    transform the tangent further.  ``ic`` and ``tg_ic`` are float64 and so
    are the results.  Any explicit Butcher tableau is accepted (default
    RK4); there is no boundary term."""
    f = _df_module(tensor, DfTendency, ic, device)
    tangent = _df_module(jtensor, DfTangent, ic, device)
    y, tg = _tgls_start(f, ic, tg_ic, device, torch.float64)
    if a is None and b is None and c is None:
        a, b, c = rk4_tableau()
    time, tts, dts = _directed_grid(t0, t, dt, forward)

    def records(fns, carries):
        steps = []
        for fk, tk in fns:
            tk = tk.with_transform(adjoint, inverse)
            steps.append(make_df_tgls_rk4_step_dynamic(fk, tk)
                         if _is_rk4(a, b, c)
                         else make_df_tgls_rk_step_dynamic(fk, tk, a, b, c))
        return _step_loops(
            steps, [(df_from_f64(y), df_from_f64(m)) for y, m in carries],
            tts, dts, write_steps,
            lambda c: (df_to_f64(c[0]), df_to_f64(c[1])))

    recs = map_shards(mesh, (y, tg), (f, tangent), records, dim=1)
    return _finish_tgls(time, recs, forward, write_steps)
