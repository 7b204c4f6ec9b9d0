#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port on one NVIDIA GPU
====================================================

Drives the port's main paths (``qgs_tpu_torch``) once each on the card: the
MAOOAM configuration (ndim 36) -> ``create_tendencies`` (on the card by
default) ->
``RungeKuttaIntegrator.integrate`` of a 4096-member ensemble, in float64
through the fused RK4 kernel and with ``precision="twofloat"`` through the
fused double-float RK4 kernel -> ``get_trajectories``.  Phases:

1. device: a CUDA card is required; prints the card's name and power limit;
2. build: compiles ``qgs_tpu_torch/csrc/rk4_fused.cu``,
   ``rk4_df_fused.cu``, ``rk4_streamed.cu`` and ``rk4_df_streamed.cu``
   with nvcc (sm_90a), in parallel;
3. each kernel against its plain PyTorch version on the card, at G = 1,
   2, 4 and 8 row groups (a launch plan's tables at each G,
   ``GROUPS_TRIED``) at B = 1, 31, 1000 and 4097 (the RK4 kernel in
   float64 and float32, the double-float one on pairs), and the
   integrator's kernel routes against their plain routes;
4. the main paths, float64 then twofloat, with the kernels' launch counts
   reset just before each; each whole trajectory is held against the plain
   float64 version at the same shapes;
5. times of each kernel and of its plain version at B = 16384, 1000 steps,
   of each kernel at its main path's shapes, and of each kernel at each
   G of ``GROUPS_TRIED`` at B = 4096 and 16384, with each kernel's bound
   (the least time the card could take for its operations or bytes) and
   its share of that bound;
6. the tangent-linear and Lyapunov paths on MAOOAM at full width (n_tg =
   n_vec = 36): ``RungeKuttaTglsIntegrator`` in float64 (Taylor, adjoint
   and card-against-CPU checks) and twofloat; backward vectors in both
   precisions, forward vectors (their forward pass one launch of each
   kernel, counted), Ginelli and subspace CLVs, card against CPU; times of
   the TGLS step, the Benettin window and its QR, the two QR methods, and
   the forward pass through K1 against its plain loop;
7. the rank-5 models (T4 and dynamic-T, ndim 38) built by
   ``create_tendencies`` on the card: ``RungeKuttaIntegrator`` in float64
   (B = 4096, 1000 steps) and twofloat (B = 1024, 300 steps) against the
   plain float64 version, the card against the CPU (B = 8, 300 steps), the
   float64 integrations through K5 (``csrc/rk4_fused.cu``: one launch a
   card each, over the layout its launch plan takes, each counted in
   ``launches_paired`` too where that is the paired one) and no launch of
   either rank-3 kernel; K5 at the T4 cell's call (B = 4096, 500 steps),
   each of its two layouts (four gathers an entry, or two over pair
   products) against its plain version, timed beside its bound and the
   plain version's time, in float64 at G = 8 and 16 in turns, and in
   float32 against the plain float32 version;
   ``initialize`` without ``number_of_dimensions``; times and peak memory of the rank-5 TGLS step
   (B = 256) and of a T4 Benettin window (B = 16); then ``QgsModel`` of
   MAOOAM saved and loaded, integrated (one K1 launch) and fed to
   ``TrajectoriesStatistics``;
8. the diagnostics (``qgs_tpu_torch.diagnostics``) on the card: one MAOOAM
   trajectory of 20,001 records (2e4 time units, one K1 launch, counted)
   through every diagnostic that applies to MAOOAM at the default 100 x 100
   grid, each timed, with its peak memory, its bound (bytes over the
   device memory's rate) and the card against the CPU on the first 200
   records (rtol 1e-12, atol 1e-12 x max|field|), and a dashboard (one
   frame drawn on Agg where matplotlib is installed); the RP and ground-coupled configurations' own diagnostics
   (orography, ground temperatures) card against CPU; then a
   ``torch.profiler`` trace (``qgs_tpu_torch.utils.profiling.trace``) of
   the float64 main path's call, summarised (window, device-busy share,
   K1's share, top five device operations, the longest idle gap), and the
   same call under ``ThroughputMeter``;
9. the parallel layer (``qgs_tpu_torch.parallel``) and the drivers: the
   integrator's default mesh (every visible card, one K1 launch a card) on
   the float64 main path, bit-equal to phase 4's call; a mesh naming
   ``cuda:0`` twice at B = 4097 (padded), float64 and twofloat, two
   launches of K1 / K2, bit-equal to the unsplit calls and held against
   the integrator's plain float64 route, timed in turns; TGLS and BLV on
   that mesh (rtol 1e-12, atol 1e-14); the row-sharded tendency on a 1 x 2
   ('ensemble', 'model') layout over ``cuda:0``; the two-process self-test
   over gloo with both ranks on ``cuda:0`` and a one-rank NCCL group's
   gather on the card; ``main`` of both drivers (``qgs_tpu_torch.drivers``),
   run short, each held against the same call on the plain route (rtol
   1e-10, atol 1e-12), their files checked;
10. the reference-compatibility surface: a reference-style MAOOAM script
   (``import qgs_tpu_torch.compat``, then the ``qgs.*`` import block of the
   reference's entry scripts) in a child process with jax and the JAX
   package blocked, ``RungeKuttaIntegrator().integrate`` at B = 4096, 1000
   steps, in float64 and twofloat: exactly one K1 and one K2 launch, the
   trajectories bit-equal to the same calls through ``qgs_tpu_torch``
   directly; the port's native C++ oracle built on the card's host, bit
   for bit the NumPy backend on MAOOAM, and K1 against it over 300 steps;
   the symbolic python export of the RP 2x2 symbolic configuration against
   the port's ``f`` and ``Df`` on the card;
11. the examples (``qgs_tpu_torch.examples``), all 16 in their catalog's
   order, each ``main(device="cuda", short=True, plot=False)``, timed,
   K1's, K2's and K5's launches counted (each example must launch the
   kernels its catalog names: the rank-5 ones K5, the symbolic ones
   none), and each held
   against the same call on the CPU at its module's tolerances;
12. models past one block's shared memory (MAOOAM 4x4/4x4, ndim 104, and
   6x6/6x6, ndim 228): the Python twins of the four kernels'
   shared-memory formulas against the compiled ones and the card's opt-in
   limit, and the kernel each precision takes; ndim 104 in float64 and
   float32 through the resident K1, in twofloat through the streamed K2,
   ndim 228 in float64 and float32 through the streamed K1 (one launch
   each), each against the plain float64 version in full and against the
   CPU on 8 members (float32 at ndim 228 for 200 steps: at ``TOL32`` over
   its first 100, then no further from float64 than the plain float32
   version), and timed; K1 at ndim 104 against its plain version
   at B = 1, 31, 4097; the streamed kernels forced at ndim 36 (B = 4097)
   and 104, bit-equal to the resident ones, and at ndim 228 against their
   plain versions; times and bounds of the streamed kernels at phase 12's
   shapes, the resolution sweep's Pallas sizes and B = 4096, and of K1 at
   ndim 104 resident and streamed; K1's single-buffer streamed variant on
   the 12x12 channel atmosphere (ndim 600, the benchmark's frozen tensor):
   one integrate of B = 4096 x 100 steps (its launch counted) and a forced
   launch, each against the plain float64 version on 64 members, and its
   time at B = 4096 beside its bound and the plain version's;
   launches that cannot run raising;
13. the long-horizon climate gate: 4 MAOOAM attractor members from the
   port's native float64 oracle, 120,000 steps of dt 0.1 (a record every
   10) by the oracle and by ``RungeKuttaIntegrator.integrate`` on the card
   in twofloat (one K2 launch), float64 and float32 (one K1 launch each);
   twofloat and float64 held to the oracle's climate (per-variable means
   and stds, the dominant spectral bin) at the tolerances of
   ``benchmarks/fidelity.py``, and pointwise on the first 5 records;
   float32's metrics printed, gated on finiteness.

Every failed phase exits nonzero before the last line, which is one JSON
object ``{"ok": true, "device": {...}}``; the line before it holds each
kernel's numbers, ``{"kernels": [...]}`` (``launches`` those of the main
paths of phases 4, 9, 10, 11, 12 and 13; the streamed kernels run on phase
12's paths only), the one before that phase 13's
numbers, ``{"fidelity": {...}}``, the one before that phase 12's
numbers, ``{"large_models": {...}}``, the one before that phase 11's,
``{"examples": {...}}``, the one before that phase 10's,
``{"compat": {...}}``, the one before that phase 6's, ``{"tangent":
{...}}``, the one before that phase 7's, ``{"rank5": {...}}``, the one
before that phase 8's, ``{"diagnostics": {...}}``, and the one before that
phase 9's, ``{"parallel": {...}}``.  Run from the repository root:

    python3 chip_smoke.py
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TOL64 = dict(rtol=1e-9, atol=1e-11)    # float64: only the summation order
                                       # and FMA contraction differ
TOL32 = dict(rtol=1e-4, atol=1e-6)     # float32 kernel vs float64 plain
# K5's layouts: the four-gather one and the paired one (phase 7 times and
# checks both; the launch plan takes one)
K5_LAYOUTS = ("resident", "paired")
# K5 in float32 against the plain float32 version, relative to the plain
# float64 run's largest |value|: both round every operation to float32
# (about 6e-8) in other orders (tests/test_torch_rk4_quartic.py, KERNEL_F32)
K5_F32 = 1e-6
TOL_DRIVER = dict(rtol=1e-10, atol=1e-12)   # a driver's run vs plain route

# peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet): vector f64
# and f32 (the kernels' sparse gathers cannot use the tensor cores), and the
# device memory's rate
PEAK_FLOPS = {"f64": 34e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check_close(name, got, ref, tol):
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    if got.shape != ref.shape:
        fail(f"{name}: shape {got.shape} != plain {ref.shape}")
    if not np.isfinite(got).all():
        fail(f"{name}: non-finite values")
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    ok = np.allclose(got, ref, **tol)
    print(f"  {name}: max_abs_err {err:.3e} (rtol {tol['rtol']}, atol "
          f"{tol['atol']}) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return err


# float32 past TOL32's 100 steps: a kernel's gap to plain float64 at most
# this many times the plain float32 version's own gap, record by record (on
# the CPU two float32 runs in different summation orders came within 1.8
# times of each other's gap at MAOOAM ndim 228 over 200 steps, 8 members)
F32_DRIFT = 3.0


def check_f32_drift(name, got, ref64, ref32, every):
    """A float32 trajectory ``got`` (B, n, a record every ``every`` steps)
    run past ``TOL32``'s 100 steps: its records of the first 100 steps held
    to the plain float64 ``ref64`` at ``TOL32``, and every record no further
    from ``ref64`` than ``F32_DRIFT`` times the plain float32 run
    ``ref32``'s own gap (``TOL32``'s atol where that is smaller).  Prints
    and returns the three gaps a record."""
    got, ref64, ref32 = (a.double().cpu().numpy() for a in (got, ref64,
                                                            ref32))
    if got.shape != ref64.shape or got.shape != ref32.shape:
        fail(f"{name}: shapes {got.shape}, {ref64.shape}, {ref32.shape}")
    if not np.isfinite(got).all():
        fail(f"{name}: non-finite values")
    steps = np.arange(got.shape[-1]) * every
    early = steps <= 100
    ok_early = np.allclose(got[..., early], ref64[..., early], **TOL32)
    gap_k, gap_p, gap_kp = (np.abs(a - b).max(axis=(0, 1)) for a, b in (
        (got, ref64), (ref32, ref64), (got, ref32)))
    ok = ok_early and bool(
        (gap_k <= np.maximum(F32_DRIFT * gap_p, TOL32["atol"])).all())
    print(f"  {name}: steps 0-100 vs plain f64 (rtol {TOL32['rtol']}, atol "
          f"{TOL32['atol']}) {'ok' if ok_early else 'MISMATCH'}; gap to "
          f"plain f64 a record {', '.join(f'{g:.3e}' for g in gap_k)}; the "
          f"plain f32 run's {', '.join(f'{g:.3e}' for g in gap_p)}; gap to "
          f"plain f32 {', '.join(f'{g:.3e}' for g in gap_kp)} (at most "
          f"{F32_DRIFT} x the plain f32 gap) {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        fail(f"{name}: float32 kernel drifts from float64 beyond float32's "
             "own drift")
    return {"steps": steps.tolist(), "gap_to_plain_f64": gap_k.tolist(),
            "plain_f32_gap_to_plain_f64": gap_p.tolist(),
            "gap_to_plain_f32": gap_kp.tolist(),
            "max_abs_err": float(gap_k.max()),
            "max_abs_err_vs_f32": float(gap_kp.max())}


# the row groups a block that phases 3 and 5 check and time K1 and K2 at,
# beside their families' G (a launch plan's tables at each G)
GROUPS_TRIED = (1, 2, 4, 8)


def at_groups(family, f, y, dts, write_every, groups):
    """One launch of the kernel ``family`` (its plan's choice) on the card
    state ``y`` (a pair for K2) with ``groups`` row groups a block."""
    y0 = y[0] if isinstance(y, tuple) else y
    from qgs_tpu_torch.ops import fused_rk4
    kernel, tables = fused_rk4.plan_tables(f, family, None, y0.dtype,
                                           y0.device, groups)
    return family.run(kernel, tables, f.shape[0], y, dts, write_every)


def cuda_ms(fn):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def bound(flops, n_bytes, peak_flops):
    """The least time in ms the card could take for ``flops`` operations at
    ``peak_flops`` and ``n_bytes`` of device memory traffic, and which of
    the two bounds it."""
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def entry_ops(coords, costs):
    """Operations of one tendency evaluation of the COO tensor ``coords``
    (output row 0, the dummy, dropped), and its entry count.  Since
    ``xx[0] = 1``, an entry costs ``costs[z]``, z the number of its
    trailing indices that are 0: for rank 3 a quadratic term, a linear one
    (no product by the 1) or a constant one."""
    coords = np.asarray(coords)
    keep = coords[0] != 0
    zeros = (coords[1:, keep] == 0).sum(axis=0)
    return int(np.asarray(costs)[zeros].sum()), int(keep.sum())


def rk4_work(B, n, coords, steps, itemsize):
    """Operations and device-memory bytes of ``steps`` RK4 steps of B
    trajectories, with no records: each step four tendency evaluations (an
    entry of a rank-r tensor costs one product a trailing index that is not
    0 and one add: 3, 2 or 1 operations at rank 3) and the combine, 14
    operations a variable; bytes: the state read and written, the step
    sizes and the tensor (index and value), each once."""
    rank = len(coords)
    ops, nnz = entry_ops(coords, range(rank, 0, -1))
    flops = B * steps * (4 * ops + 14 * n)
    n_bytes = (2 * itemsize * B * n + 8 * steps
               + nnz * (4 * (rank - 1) + itemsize))
    return flops, n_bytes


def df_rk4_work(B, n, coords, steps):
    """The same for the double-float kernel, in float32 operations: a
    double-float product costs 10 and an add 11, so a quadratic entry 31, a
    linear one 21 and a constant one 11, and the combine 125 a variable a
    step (``rk4_df_fused.cu``); the state and the values are (hi, lo)
    pairs."""
    ops, nnz = entry_ops(coords, (31, 21, 11))
    flops = B * steps * (4 * ops + 125 * n)
    n_bytes = 2 * 8 * B * n + 8 * steps + nnz * 12
    return flops, n_bytes


def maooam_params(QgParams):
    """The MAOOAM configuration of ``qgs_maooam.py``."""
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    pars.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3,
                                         'hlambda': 15.06})
    pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
    pars.atemperature_params.set_insolation(103.3333, 0)
    pars.gotemperature_params.set_insolation(310., 0)
    return pars


def best_ms(fn, count=1):
    """The better of two CUDA-event timings of ``fn`` (after one warm-up
    call), divided by ``count``."""
    fn()
    return min(cuda_ms(fn) for _ in range(2)) / count


def unit_columns_err(v):
    """Largest deviation of the column norms of (B, n, k, ...) from 1."""
    return float((v.norm(dim=1) - 1).abs().max())


def tangent_phase(f, Df, qgt, card, dev):
    """6. The tangent-linear system and the Lyapunov toolbox on MAOOAM:
    checks (each ``fail``s the run), then times.  Returns the numbers and
    each kernel's launches on the forward-vector pass."""
    import torch
    from qgs_tpu_torch.integrators.integrator import RungeKuttaTglsIntegrator
    from qgs_tpu_torch.integrators.rk import (integrate_runge_kutta,
                                              integrate_runge_kutta_tgls,
                                              make_tgls_step, rk4_tableau)
    from qgs_tpu_torch.ops import fused_df_rk4, fused_rk4
    from qgs_tpu_torch.ops.contraction import (make_direct_tangent,
                                               make_tendency_fns)
    from qgs_tpu_torch.ops.twofloat import (DfTendency, df_from_f64,
                                            df_to_f64,
                                            make_df_tangent_contraction,
                                            make_df_tgls_rk4_step_dynamic)
    from qgs_tpu_torch.toolbox import lyapunov as lyap

    start = time.perf_counter()
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        fail("float32 matmuls may run in TF32: the tangent paths need IEEE "
             "float32")
    T, JT = qgt.tensor, qgt.jacobian_tensor
    tensors = (T, JT)
    n = T.shape[0] - 1
    rng = np.random.default_rng(6)
    ic = torch.as_tensor(rng.random((256, n)) * 0.01, device=dev)
    out = {}

    def fmat_close(name, got, ref):
        scale = max(float(ref.abs().max()), 1.0)
        return check_close(name, got, ref, dict(rtol=TOL64["rtol"],
                                                atol=TOL64["atol"] * scale))

    # -- TGLS float64: the integrator, B=256, 1000 steps of dt 0.1 --------
    tgls = RungeKuttaTglsIntegrator()
    tgls.set_func(f, Df)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tgls.integrate(0., 100., 0.1, ic=ic, write_steps=0)
    _, x100, M = tgls.get_trajectories()
    torch.cuda.synchronize()
    out["tgls_f64_B256_1000_steps_s"] = s = time.perf_counter() - t0
    print(f"[6] TGLS float64 integrate B={ic.shape[0]}, 1000 steps, tg_ic = "
          f"I_{n}: "
          f"{s:.3f} s ({s:.6f} ms/step); {card}", flush=True)
    if (tuple(M.shape) != (256, n, n) or M.device.type != "cuda"
            or not torch.isfinite(M).all()):
        fail(f"fundamental matrices {tuple(M.shape)} on {M.device}")

    # Taylor: x(t; x0 + eps v) - x(t; x0) through K1 against eps M v
    fused_rk4.launches = 0
    x0 = ic[:3]
    v = torch.as_tensor(rng.standard_normal((3, n)), device=dev)
    v = v / v.norm(dim=1, keepdim=True)
    Mv = torch.einsum('bij,bj->bi', M[:3], v)
    _, xt = integrate_runge_kutta(f.batched, 0., 100., 0.1, x0, write_steps=0)
    rem = []
    for eps in (1e-6, 1e-7):
        _, xe = integrate_runge_kutta(f.batched, 0., 100., 0.1, x0 + eps * v,
                                      write_steps=0)
        rem.append(((xe - xt) - eps * Mv).norm(dim=1))
    ratio = (rem[0] / rem[1]).cpu().numpy()
    rel = float((rem[0] / (1e-6 * Mv.norm(dim=1))).max())
    print(f"  Taylor (t=100, K1 launches {fused_rk4.launches}): remainder "
          f"ratio eps 1e-6 / 1e-7 = {np.round(ratio, 3).tolist()}, relative "
          f"remainder at 1e-6 {rel:.3e}", flush=True)
    if fused_rk4.launches < 3:
        fail("the Taylor check did not run through K1")
    if not ((ratio > 50) & (ratio < 200)).all() or rel > 1e-3:
        fail("the tangent-linear propagator fails the Taylor check")
    out["taylor_remainder_ratio"] = ratio.tolist()

    # adjoint identity over 100 pairs, one step (tests/test_tlad.py:77-96)
    def mismatch(dt):
        r = np.random.default_rng(3)
        dy = torch.as_tensor(r.standard_normal((n, 100)), device=dev)
        dyb = torch.as_tensor(r.standard_normal((n, 100)), device=dev)
        _, _, tl = integrate_runge_kutta_tgls(f.batched, Df.batched, 0., dt,
                                              dt, x100[:1], dy.T,
                                              write_steps=0)
        _, _, ad = integrate_runge_kutta_tgls(f.batched, Df.batched, 0., dt,
                                              dt, x100[:1], dyb.T,
                                              write_steps=0, adjoint=True)
        n1, n2 = (tl * dyb).sum(0), (dy * ad).sum(0)
        return float(((n1 - n2).abs() / n1.abs().clamp(min=1.0)).max())

    err_h, err_h2 = mismatch(0.1), mismatch(0.05)
    order = np.log2(err_h / err_h2)
    print(f"  adjoint identity: {err_h:.3e} at dt 0.1, {err_h2:.3e} at dt "
          f"0.05, order {order:.2f}", flush=True)
    if err_h >= 1e-3 or order <= 2.5:
        fail("the adjoint identity fails")

    # card against CPU: the same call at B=8, 300 steps
    f_c, Df_c = make_tendency_fns(T, JT, device="cpu")
    res = {}
    runs = {"cpu": (f_c, Df_c, ic[:8].cpu()),
            "cuda": (f.batched, Df.batched, ic[:8])}
    for name, (fn, jac, y) in runs.items():
        integ = RungeKuttaTglsIntegrator()
        integ.set_func(fn, jac)
        integ.integrate(0., 30., 0.1, ic=y, write_steps=0)
        res[name] = integ.get_trajectories()
    check_close("TGLS float64 card vs CPU, B=8, 300 steps, trajectory",
                res["cuda"][1], res["cpu"][1], TOL64)
    fmat_close("TGLS float64 card vs CPU, fundamental matrices",
               res["cuda"][2], res["cpu"][2])

    # -- TGLS twofloat against TGLS float64 on the card, B=256, 300 steps --
    ref = RungeKuttaTglsIntegrator()
    ref.set_func(f, Df)
    ref.integrate(0., 30., 0.1, ic=ic, write_steps=0)
    tdf = RungeKuttaTglsIntegrator(precision="twofloat")
    tdf.set_func(f, Df)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tdf.integrate(0., 30., 0.1, ic=ic, write_steps=0)
    _, ydf, Mdf = tdf.get_trajectories()
    torch.cuda.synchronize()
    out["tgls_df_B256_300_steps_s"] = s = time.perf_counter() - t0
    print(f"[6] TGLS twofloat integrate B={ic.shape[0]}, 300 steps: "
          f"{s:.3f} s "
          f"({s / 0.3:.3f} ms/step); {card}", flush=True)
    check_close("TGLS twofloat vs float64 on the card, trajectory", ydf,
                ref.get_trajectories()[1], TOL64)
    fmat_close("TGLS twofloat vs float64 on the card, fundamental matrices",
               Mdf, ref.get_trajectories()[2])

    # -- Lyapunov, from an attractor state (10,000 K1 steps) ---------------
    _, xa = integrate_runge_kutta(f.batched, 0., 1000., 0.1, ic[:16],
                                  write_steps=0)
    span = (0., 10., 60., 0.1, 0.1)
    _, _, e64, q64 = lyap.compute_backward_lyapunovs(
        f.batched, Df.batched, *span, xa, tensors=tensors)
    _, _, edf, qdf = lyap.compute_backward_lyapunovs(
        f.batched, Df.batched, *span, xa, tensors=tensors,
        precision="twofloat")
    blv_gap = float((e64.mean(-1) - edf.mean(-1)).abs().max())
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    orth = max(float((q[..., -1].mT @ q[..., -1] - eye).abs().max())
               for q in (q64, qdf))
    print(f"  BLV B=16 (0, 10, 60, 0.1, 0.1): twofloat vs float64 mean "
          f"exponents {blv_gap:.3e} (limit 5e-8); Q orthonormal to "
          f"{orth:.3e} (limit 1e-12); leading mean exponents "
          f"{e64.mean(-1)[0, :3].tolist()}", flush=True)
    if not blv_gap < 5e-8 or not orth < 1e-12:
        fail("backward Lyapunov vectors: twofloat and float64 disagree")

    # forward vectors through the estimator, each kernel's launches counted
    flv, flv_launches = {}, {}
    for precision in ("float64", "twofloat"):
        est = lyap.LyapunovsEstimator(precision=precision)
        est.set_func(f, Df)
        fused_rk4.launches = fused_df_rk4.launches = 0
        est.compute_lyapunovs(0., 10., 20., 0.1, 0.1, xa, forward=True)
        flv_launches[precision] = {"rk4_fused": fused_rk4.launches,
                                   "rk4_df_fused": fused_df_rk4.launches}
        flv[precision] = est.get_lyapunovs()
    print(f"  FLV B=16 (0, 10, 20) launches {flv_launches}", flush=True)
    if (flv_launches["float64"]["rk4_fused"] < 1
            or flv_launches["twofloat"]["rk4_df_fused"] < 1):
        fail("the forward-vector pass did not launch its kernel")
    _, _, e_plain, _ = lyap.compute_forward_lyapunovs(
        lambda t, x: f.batched(t, x), Df.batched, 0., 10., 20., 0.1, 0.1, xa,
        tensors=tensors)
    err_flv = check_close("FLV float64, kernel route vs plain route, "
                          "exponents", torch.as_tensor(flv["float64"][2]),
                          e_plain, TOL64)
    fdf = DfTendency(T.coords, T.data, T.shape, device=dev)
    xa_df = df_from_f64(xa)
    err_fwd_df = check_close(
        "FLV twofloat forward pass, K2 vs plain route (200 windows)",
        df_to_f64(lyap.forward_boundary_states(fdf, xa_df, 200, 1, 0.1)),
        df_to_f64(lyap.forward_boundary_states(lambda h, lo: fdf(h, lo),
                                               xa_df, 200, 1, 0.1)), TOL64)
    flv_gap = float(np.abs(flv["float64"][2].mean(-1)
                           - flv["twofloat"][2].mean(-1)).max())
    print(f"  FLV twofloat vs float64 mean exponents {flv_gap:.3e}",
          flush=True)

    # CLVs at B=4
    _, traj_g, _, clv_g = lyap.compute_clvs_ginelli(
        f.batched, Df.batched, 0., 10., 20., 30., 0.1, 0.1, xa[:4],
        tensors=tensors)
    step = make_tgls_step(f.batched, Df.batched, *rk4_tableau())
    T_g = clv_g.shape[-1]
    y_k = torch.movedim(traj_g[..., :-1], -1, 0).reshape(-1, n)
    c_k = torch.movedim(clv_g[..., :-1], -1, 0).reshape(-1, n, n)
    _, c_next = step((y_k, c_k), 0., 0.1)
    c_next = c_next / c_next.norm(dim=1, keepdim=True)
    cov = float((c_next * torch.movedim(clv_g[..., 1:], -1, 0).reshape(
        -1, n, n)).sum(1).abs().min())
    norm_g = unit_columns_err(clv_g)
    out_s = lyap.compute_clvs_subspace(
        f.batched, Df.batched, 0., 10., 20., 30., 0.1, 0.1, xa[:4],
        tensors=tensors, return_blvs=True)
    clv_s, (_, blv_s) = out_s[3], out_s[4]
    norm_s = unit_columns_err(clv_s)
    align_s = float((clv_s[:, :, 0] * blv_s[:, :, 0]).sum(1).abs().min())
    print(f"  CLVs B=4 (0, 10, 20, 30): Ginelli unit norms {norm_g:.3e}, "
          f"covariance over one window min |cos| {cov:.15f} ({T_g} records); "
          f"subspace unit norms {norm_s:.3e}, leading CLV vs leading BLV "
          f"min |dot| {align_s:.15f}", flush=True)
    if norm_g > 1e-10 or norm_s > 1e-10:
        fail("CLVs are not unit vectors")
    if cov < 1 - 1e-6 or align_s < 1 - 1e-6:
        fail("CLVs: covariance or leading-vector alignment fails")
    if not (torch.isfinite(out_s[2]).all() and torch.isfinite(clv_g).all()):
        fail("non-finite CLV exponents or vectors")

    # card against CPU, backward exponents at B=2
    _, _, e_cpu, _ = lyap.compute_backward_lyapunovs(
        f_c, Df_c, *span, xa[:2].cpu(), tensors=tensors)
    err_blv_cpu = check_close("BLV B=2 card vs CPU, exponents",
                              e64[:2], e_cpu, dict(rtol=0, atol=1e-9))

    # -- times --------------------------------------------------------------
    tab = rk4_tableau()
    tangent = make_direct_tangent(JT, device=dev)
    df_tangent = make_df_tangent_contraction(JT, device=dev)
    steps = {
        "float64, Jacobian route (the integrator)":
            make_tgls_step(f.batched, Df.batched, *tab),
        "float64, direct tangent (the Benettin window)":
            make_tgls_step(f.batched, Df.batched, *tab, tangent=tangent),
        "twofloat": make_df_tgls_rk4_step_dynamic(fdf, df_tangent)}
    out["tgls_step_ms"] = {}
    for B, counts in ((256, (20, 5)), (4096, (5, 2))):
        y = torch.as_tensor(rng.random((B, n)) * 0.01, device=dev)
        dm = torch.eye(n, dtype=torch.float64, device=dev).expand(B, n, n)
        for name, step_fn in steps.items():
            df = name == "twofloat"
            carry = ((df_from_f64(y), df_from_f64(dm.contiguous())) if df
                     else (y, dm))
            count = counts[1] if df else counts[0]

            def run():
                c = carry
                for _ in range(count):
                    c = step_fn(c, 0., 0.1)
            ms = best_ms(run, count)
            out["tgls_step_ms"][f"{name} B={B}"] = ms
            print(f"[6] TGLS step {name}, B={B}: {ms:.3f} ms/step "
                  f"({B / ms * 1e3:.4g} traj-steps/s); {card}", flush=True)

    out["window_ms"], out["qr_ms"] = {}, {}
    for B in (16, 256):
        y = xa[:B] if B <= 16 else ic
        Q = torch.linalg.qr(torch.as_tensor(rng.standard_normal((n, n)),
                                            device=dev))[0].expand(B, n, n)
        for name, window, carry, count in (
                ("float64", lyap.make_window_step(
                    f.batched, Df.batched, 0.1, 0.1, tangent=tangent),
                 (y, Q), 20),
                ("twofloat", lyap.make_window_step_df(
                    fdf, df_tangent, 0.1, 0.1),
                 (df_from_f64(y), df_from_f64(Q.contiguous())), 10)):
            def run():
                c = carry
                for _ in range(count):
                    c, _ = window(c, 0.)
            w_ms = best_ms(run, count)
            M_b = torch.as_tensor(rng.standard_normal((B, n, n)), device=dev)
            q_ms = best_ms(lambda: [lyap.batched_qr(M_b) for _ in range(20)],
                           20)
            out["window_ms"][f"{name} B={B}"] = w_ms
            print(f"[6] Benettin window {name} (dt = mdt = 0.1), B={B}: "
                  f"{w_ms:.3f} ms/window, QR {q_ms:.3f} ms, QR share "
                  f"{q_ms / w_ms:.3f}; {card}", flush=True)
    for B in (16, 256, 4096):
        M_b = torch.as_tensor(rng.standard_normal((B, n, n)), device=dev)
        qr = {m: best_ms(lambda: [lyap.batched_qr(M_b, m) for _ in range(10)],
                         10) for m in ("householder", "cholqr2")}
        out["qr_ms"][f"B={B}"] = qr
        print(f"[6] batched_qr (B, {n}, {n}) float64, B={B}: householder "
              f"{qr['householder']:.3f} ms, cholqr2 {qr['cholqr2']:.3f} ms, "
              f"ratio {qr['householder'] / qr['cholqr2']:.2f}; {card}",
              flush=True)
    fwd = {"K1": best_ms(lambda: lyap.forward_boundary_states(
        f.batched, xa, 500, 1, 0.1)),
        "plain": best_ms(lambda: lyap.forward_boundary_states(
            lambda t, x: f.batched(t, x), xa, 500, 1, 0.1))}
    out["flv_forward_pass_ms"] = fwd
    print(f"[6] FLV forward pass B=16, 500 windows of one step: K1 "
          f"{fwd['K1']:.3f} ms, plain loop {fwd['plain']:.3f} ms; {card}",
          flush=True)
    out.update(blv_twofloat_vs_f64=blv_gap, flv_twofloat_vs_f64=flv_gap,
               flv_kernel_vs_plain=err_flv, flv_df_forward_vs_plain=err_fwd_df,
               blv_card_vs_cpu=err_blv_cpu, ginelli_covariance_min=cov,
               subspace_alignment_min=align_s, adjoint=[err_h, err_h2],
               seconds=time.perf_counter() - start, card=card)
    print(f"[6] phase 6 took {out['seconds']:.1f} s", flush=True)
    return out, flv_launches


def quartic_params(QgParams, **scheme):
    """The symbolic 2x2 atmosphere + 2x4 ocean of ``tests/test_t4.py:20-23``
    with a rank-5 radiation scheme (``T4=True`` or ``dynamic_T=True``)."""
    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8}, **scheme)
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
    pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
    pars.set_oceanic_basin_fourier_modes(2, 4, mode='symbolic')
    return pars


def near_ic(pars, B, seed):
    """B states near the stationary temperatures (``tests/test_t4.py``)."""
    x = np.random.default_rng(seed).random((B, pars.ndim)) * 0.01
    x[:, pars.variables_range[0]] = 0.1
    x[:, pars.variables_range[2]] = 0.12
    return x


def peak_ms_mb(fn, count):
    """``best_ms(fn, count)``, the peak of device memory allocated during
    one more call and the memory allocated before it, in MB."""
    import torch
    ms = best_ms(fn, count)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**20
    fn()
    torch.cuda.synchronize()
    return ms, torch.cuda.max_memory_allocated() / 2**20, base


def rank5_phase(card, dev):
    """7. The rank-5 models on the card, then ``QgsModel`` and
    ``TrajectoriesStatistics``: checks (each ``fail``s the run) and times.
    Returns the numbers."""
    import torch
    from qgs_tpu_torch.params.params import QgParams
    from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
    from qgs_tpu_torch.integrators.rk import (make_tgls_step, rk4_tableau,
                                              time_grid)
    from qgs_tpu_torch.integrators.statistics import TrajectoriesStatistics
    from qgs_tpu_torch.models.model import QgsModel
    from qgs_tpu_torch.models.tendencies import create_tendencies
    from qgs_tpu_torch.ops import _build, fused_df_rk4, fused_rk4
    from qgs_tpu_torch.ops import fused_rk4_quartic as k5
    from qgs_tpu_torch.ops.contraction import (Tendency, make_direct_tangent,
                                               make_tendency_fns)
    from qgs_tpu_torch.ops.twofloat import (DfTangent, DfTendency,
                                            df_from_f64,
                                            make_df_tgls_rk4_step_dynamic)
    from qgs_tpu_torch.toolbox import lyapunov as lyap

    start = time.perf_counter()
    out = {"card": card}
    tab = rk4_tableau()
    lib = _build.load_library()

    def counts():
        return {"rk4_fused": fused_rk4.launches,
                "rk4_df_fused": fused_df_rk4.launches,
                "rk4_quartic": k5.launches,
                "rk4_paired": k5.launches_paired}

    fused_rk4.launches = fused_df_rk4.launches = k5.launches = 0
    k5.launches_paired = 0
    for name, scheme in (("t4", dict(T4=True)),
                         ("dynT", dict(dynamic_T=True))):
        res = out[name] = {}
        t0 = time.perf_counter()
        pars = quartic_params(QgParams, **scheme)
        f, Df, qgt = create_tendencies(pars, return_qgtensor=True)
        res["setup_s"] = time.perf_counter() - t0
        T, JT = qgt.tensor, qgt.jacobian_tensor
        n = pars.ndim
        if (f.batched.device.type != "cuda" or len(T.shape) != 5
                or n != 38):
            fail(f"{name}: rank {len(T.shape)}, ndim {n} on "
                 f"{f.batched.device}")
        res["layout"] = {
            "tendency_slots": f.batched.vals.numel()
            + f.batched.chunks.numel(),
            "tendency_chunk": f.batched.vals.shape[1],
            "tendency_entries": int((T.coords[0] != 0).sum()),
            "jacobian_slots": Df.batched.vals.numel()
            + Df.batched.chunks.numel(),
            "jacobian_chunk": Df.batched.vals.shape[1],
            "jacobian_entries": int(((JT.coords[0] != 0)
                                     & (JT.coords[1] != 0)).sum())}
        print(f"[7] {name}: create_tendencies on the card in "
              f"{res['setup_s']:.3f} s; layout {res['layout']}", flush=True)

        # float64, B=4096, 1000 steps, a record every 100: one K5 launch a
        # card, over the layout its launch plan takes (the paired one counts
        # in launches_paired too)
        ic = torch.as_tensor(near_ic(pars, 4096, 0), device=dev)
        integ = RungeKuttaIntegrator()
        integ.set_func(f)
        torch.cuda.synchronize()
        k5.launches = k5.launches_paired = 0
        t0 = time.perf_counter()
        integ.integrate(0., 100., 0.1, ic=ic, write_steps=100)
        times, traj = integ.get_trajectories()
        torch.cuda.synchronize()
        res["f64_B4096_1000_steps_s"] = s64 = time.perf_counter() - t0
        res["k5_launches"] = k5.launches
        res["k5_paired_launches"] = k5.launches_paired
        res["k5_layout"] = fused_rk4.launch_plan(f.batched, k5.K5,
                                                 torch.float64, dev).kernel
        if k5.launches != torch.cuda.device_count():
            fail(f"{name}: the float64 integrate ran {k5.launches} K5 "
                 f"launches, not one a card")
        if k5.launches_paired != k5.launches * (res["k5_layout"] == "paired"):
            fail(f"{name}: the float64 integrate over the "
                 f"{res['k5_layout']} layout counted {k5.launches_paired} of "
                 f"its {k5.launches} K5 launches in launches_paired")
        if tuple(traj.shape) != (4096, n, 11) or not torch.isfinite(
                traj).all() or len(times) != 11:
            fail(f"{name} float64 trajectory {tuple(traj.shape)}")
        dts = torch.as_tensor(np.diff(time_grid(0., 100., 0.1)), device=dev)
        _, recs = fused_rk4.fused_rk4_reference(f.batched, ic, dts, 100)
        res["f64_vs_plain"] = check_close(
            f"{name} float64 integrate B=4096 1000 steps vs plain "
            "fused_rk4_reference", traj, torch.movedim(
                torch.cat([ic[None], recs]), 0, -1), TOL64)
        print(f"[7] {name} float64 integrate B=4096, 1000 steps: {s64:.3f} s "
              f"({4096 * 1000 / s64:.4g} traj-steps/s; K5 over the "
              f"{res['k5_layout']} layout, launches {k5.launches}, "
              f"launches_paired {k5.launches_paired}); {card}", flush=True)

        # twofloat, B=1024, 300 steps, against the float64 run
        idf = RungeKuttaIntegrator(precision="twofloat")
        idf.set_func(f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idf.integrate(0., 30., 0.1, ic=ic[:1024], write_steps=100)
        _, tdf = idf.get_trajectories()
        torch.cuda.synchronize()
        res["df_B1024_300_steps_s"] = sdf = time.perf_counter() - t0
        res["df_vs_f64"] = check_close(
            f"{name} twofloat integrate B=1024 300 steps vs float64", tdf,
            traj[:1024, :, :4], TOL64)
        print(f"[7] {name} twofloat integrate B=1024, 300 steps: {sdf:.3f} s "
              f"({1024 * 300 / sdf:.4g} traj-steps/s); {card}", flush=True)

        # the card against the CPU, B=8, 300 steps
        f_c, _ = make_tendency_fns(T, JT, device="cpu")
        ends = {}
        for label, fn, y in (("cpu", f_c, ic[:8].cpu()),
                             ("cuda", f.batched, ic[:8])):
            icpu = RungeKuttaIntegrator()
            icpu.set_func(fn)
            icpu.integrate(0., 30., 0.1, ic=y, write_steps=0)
            ends[label] = icpu.get_trajectories()[1]
        res["card_vs_cpu"] = check_close(
            f"{name} float64 card vs CPU, B=8, 300 steps", ends["cuda"],
            ends["cpu"], TOL64)
        del ic, traj, recs, tdf, integ, idf

        # TGLS steps at B=256, identity tangent blocks: time and peak memory
        fdf = DfTendency(T.coords, T.data, T.shape, device=dev)
        steps = {
            "float64, Jacobian route (the integrator)":
                make_tgls_step(f.batched, Df.batched, *tab),
            "float64, direct tangent (the Benettin window)":
                make_tgls_step(f.batched, Df.batched, *tab,
                               tangent=make_direct_tangent(JT, device=dev)),
            "twofloat": make_df_tgls_rk4_step_dynamic(
                fdf, DfTangent(JT.coords, JT.data, JT.shape, device=dev))}
        y = torch.as_tensor(near_ic(pars, 256, 1), device=dev)
        dm = torch.eye(n, dtype=torch.float64, device=dev).expand(
            256, n, n).contiguous()
        res["tgls_step_B256"] = {}
        for label, step_fn in steps.items():
            df = label == "twofloat"
            carry = (df_from_f64(y), df_from_f64(dm)) if df else (y, dm)
            count = 3 if df else 10

            def run():
                c = carry
                for _ in range(count):
                    c = step_fn(c, 0., 0.1)
            ms, mb, base = peak_ms_mb(run, count)
            res["tgls_step_B256"][label] = {"ms": ms, "peak_mb": mb,
                                            "base_mb": base}
            print(f"[7] {name} TGLS step {label}, B=256: {ms:.3f} ms/step "
                  f"({256 / ms * 1e3:.4g} traj-steps/s), peak "
                  f"{mb:.1f} MB allocated ({base:.1f} MB before it); "
                  f"{card}", flush=True)
            if mb >= 2048:
                fail(f"{name} TGLS step {label} peaks at {mb:.1f} MB "
                     "(limit 2 GB)")

        # the rank-5 plain RK4 step, B=4096, against the least time the
        # card could take for it
        yb = torch.as_tensor(near_ic(pars, 4096, 2), device=dev)
        ms = best_ms(lambda: fused_rk4.fused_rk4_reference(
            f.batched, yb, dts[:10]), 10)
        b_ms, b_by = bound(*rk4_work(4096, n, T.coords, 1, 8),
                           PEAK_FLOPS["f64"])
        res["rk4_step_B4096"] = {"ms": ms, "bound_ms": b_ms,
                                 "bound_by": b_by}
        print(f"[7] {name} plain RK4 step B=4096: {ms:.3f} ms/step "
              f"({4096 / ms * 1e3:.4g} traj-steps/s), bound {b_ms:.4f} ms "
              f"({b_by}), share {b_ms / ms:.5f}; {card}", flush=True)

        # K5 at the T4 cell's call, B=4096 x 500 steps of dt 0.01 with a
        # record every 50: the time (better of two) of each layout, the
        # four-gather one ("resident") and the paired one, at G = 8 and at
        # K5's G = 16 in turns (a launch plan's tables of each), their
        # bound, and the plain version's time (one run) and records, each
        # layout's forced launch held against them at TOL64
        dts500 = torch.full((500,), 0.01, dtype=torch.float64, device=dev)
        rule = k5.K5.groups
        plan = fused_rk4.launch_plan(f.batched, k5.K5, torch.float64, dev)
        npairs = k5.pair_count(T.coords, T.shape[0])
        twins = dict(zip(k5.K5.kernels, plan.sizes))
        smem = {kern: (twins[kern], c_formula) for kern, c_formula in (
            ("resident", lib.qgs_rk4_fused_smem_bytes(
                T.shape[0], rule, plan.rows.width, 1)),
            ("paired", lib.qgs_rk4_paired_smem_bytes(
                T.shape[0], npairs, rule, plan.rows.width, 1)))}
        if any(twin != c for twin, c in smem.values()):
            fail(f"{name}: K5's shared-memory twins {smem} differ from the "
                 "kernel's formulas")
        tables = {(kern, g): fused_rk4.plan_tables(
            f.batched, k5.K5, kern, torch.float64, dev, g)[1]
            for kern in K5_LAYOUTS for g in (8, rule)}
        per_g = {f"{kern} G={g}": [] for kern, g in tables}
        for key in list(tables) + list(reversed(tables)):
            per_g[f"{key[0]} G={key[1]}"].append(best_ms(
                lambda: k5.K5.run(key[0], tables[key], T.shape[0], yb,
                                  dts500, 50)))
        got = {kern: k5.K5.launch(f.batched, yb, dts500, 50, kernel=kern)
               for kern in K5_LAYOUTS}
        plain = {}
        plain_ms = cuda_ms(lambda: plain.setdefault(
            "out", fused_rk4.fused_rk4_reference(f.batched, yb, dts500, 50)))
        b_ms, b_by = bound(*rk4_work(4096, n, T.coords, 500, 8),
                           PEAK_FLOPS["f64"])
        by_layout = {}
        for kern in K5_LAYOUTS:
            ms = min(per_g[f"{kern} G={rule}"])
            by_layout[kern] = {
                "ms": ms, "share_of_bound": b_ms / ms,
                "max_abs_err": max(check_close(
                    f"{name} K5 {kern} B=4096 500 steps vs plain {part}", a,
                    b, TOL64) for part, a, b in zip(
                        ("final", "records"), got[kern], plain["out"]))}
        k_ms = by_layout[plan.kernel]["ms"]
        res["k5_B4096_500_steps"] = {
            "ms": k_ms, "groups": rule, "layout": plan.kernel,
            "pairs": npairs, "records": int(plan.rows.load.sum()),
            "smem_bytes": {kern: v[0] for kern, v in smem.items()},
            "ms_per_groups": {k: min(v) for k, v in per_g.items()},
            "by_layout": by_layout,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / k_ms,
            "max_abs_err": by_layout[plan.kernel]["max_abs_err"]}
        print(f"[7] {name} K5 B=4096 x 500 steps: {k_ms:.3f} ms, the "
              f"{plan.kernel} layout at G={rule} "
              f"({4096 * 500 / k_ms * 1e3:.4g} traj-steps/s; "
              f"{plan.rows.load.sum()} records, {npairs} pairs; per layout "
              f"and G {res['k5_B4096_500_steps']['ms_per_groups']}), plain "
              f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), share "
              f"{b_ms / k_ms:.4f}; {card}", flush=True)

        # the same call in float32 (the route's other K5 instantiation),
        # each layout against the plain float32 version on the same inputs
        # within K5_F32 of the plain float64 run's largest |value|
        scale = max(a.abs().max().item() for a in plain["out"])
        del got, plain, tables
        f32 = Tendency(T.coords, T.data, T.shape, torch.float32, dev)
        y32 = yb.float()
        layout32 = fused_rk4.launch_plan(f32, k5.K5, torch.float32,
                                         dev).kernel
        ms_layout32 = {kern: best_ms(lambda: k5.K5.launch(
            f32, y32, dts500, 50, kernel=kern)) for kern in K5_LAYOUTS}
        ms32 = ms_layout32[layout32]
        plain = {}
        plain32_ms = cuda_ms(lambda: plain.setdefault(
            "out", fused_rk4.fused_rk4_reference(f32, y32, dts500, 50)))
        b_ms, b_by = bound(*rk4_work(4096, n, T.coords, 500, 4),
                           PEAK_FLOPS["f32"])
        by_layout32 = {}
        for kern in K5_LAYOUTS:
            err = max(check_close(
                f"{name} K5 {kern} float32 B=4096 500 steps vs plain float32 "
                f"{part}", a, b, dict(rtol=0, atol=K5_F32 * scale))
                for part, a, b in zip(("final", "records"), k5.K5.launch(
                    f32, y32, dts500, 50, kernel=kern), plain["out"]))
            by_layout32[kern] = {
                "ms": ms_layout32[kern],
                "share_of_bound": b_ms / ms_layout32[kern],
                "max_abs_err": err, "err_of_scale": err / scale}
        err32 = by_layout32[layout32]["max_abs_err"]
        res["k5_f32_B4096_500_steps"] = {
            "ms": ms32, "layout": layout32, "by_layout": by_layout32,
            "plain_ms": plain32_ms, "bound_ms": b_ms,
            "bound_by": b_by, "share_of_bound": b_ms / ms32,
            "max_abs_err": err32, "err_of_scale": err32 / scale}
        print(f"[7] {name} K5 float32 B=4096 x 500 steps: {ms32:.3f} ms, the "
              f"{layout32} layout ({4096 * 500 / ms32 * 1e3:.4g} "
              f"traj-steps/s; per layout {ms_layout32}), plain "
              f"{plain32_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), share "
              f"{b_ms / ms32:.4f}, gap {err32 / scale:.3e} of scale; {card}",
              flush=True)
        del plain, f32, y32

        if name == "t4":
            # Benettin windows at B=16 (one substep, dt = mdt = 0.1)
            y16 = y[:16]
            Q = torch.linalg.qr(torch.as_tensor(np.random.default_rng(
                3).standard_normal((n, n)), device=dev))[0].expand(
                    len(y16), n, n)
            res["window_B16"] = {}
            for label, window, carry, count in (
                    ("float64", lyap.make_window_step(
                        f.batched, Df.batched, 0.1, 0.1,
                        tangent=make_direct_tangent(JT, device=dev)),
                     (y16, Q), 10),
                    ("twofloat", lyap.make_window_step_df(
                        fdf, DfTangent(JT.coords, JT.data, JT.shape,
                                       device=dev), 0.1, 0.1),
                     (df_from_f64(y16), df_from_f64(Q.contiguous())), 5)):
                def run():
                    c = carry
                    for _ in range(count):
                        c, _ = window(c, 0.)
                ms, mb, base = peak_ms_mb(run, count)
                res["window_B16"][label] = {"ms": ms, "peak_mb": mb,
                                            "base_mb": base}
                print(f"[7] T4 Benettin window {label}, B=16: {ms:.3f} "
                      f"ms/window, peak {mb:.1f} MB allocated ({base:.1f} "
                      f"MB before it); {card}", flush=True)
            _, _, e64, _ = lyap.compute_backward_lyapunovs(
                f.batched, Df.batched, 0., 0.5, 1., 0.1, 0.1, y16,
                tensors=(T, JT))
            _, _, edf, _ = lyap.compute_backward_lyapunovs(
                f.batched, Df.batched, 0., 0.5, 1., 0.1, 0.1, y16,
                tensors=(T, JT), precision="twofloat")
            res["blv_df_vs_f64"] = check_close(
                "T4 BLV B=16 (0, 0.5, 1) twofloat vs float64 exponents", edf,
                e64, dict(rtol=0, atol=1e-9))

        # the dimension probe: initialize without number_of_dimensions
        integ = RungeKuttaIntegrator()
        integ.set_func(f)
        integ.initialize(1., 0.1, number_of_trajectories=4,
                         rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        integ.integrate(0., 1., 0.1, write_steps=0)
        x = integ.get_trajectories()[1]
        torch.cuda.synchronize()
        if integ.n_dim != n or not torch.isfinite(x).all():
            fail(f"{name}: initialize without number_of_dimensions")

    # the rank-3 kernels across the whole phase; K5, and those of its
    # launches over the paired layout, in the two float64 integrations
    # alone (the timing launches above are not counted)
    out["rank5_launches"] = dict(
        counts(),
        rk4_quartic=sum(out[m]["k5_launches"] for m in ("t4", "dynT")),
        rk4_paired=sum(out[m]["k5_paired_launches"] for m in ("t4", "dynT")))
    print(f"[7] launches across the rank-5 runs: {out['rank5_launches']}",
          flush=True)
    if out["rank5_launches"]["rk4_fused"] or \
            out["rank5_launches"]["rk4_df_fused"]:
        fail("a rank-3 kernel was launched on a rank-5 path")

    # the dimension probe on MAOOAM (the fault's own case), then QgsModel
    pars = maooam_params(QgParams)
    f, _ = create_tendencies(pars)
    integ = RungeKuttaIntegrator()
    integ.set_func(f)
    integ.initialize(1., 0.1, number_of_trajectories=4,
                     rng=np.random.default_rng(0))
    torch.cuda.synchronize()
    integ.integrate(0., 1., 0.1, write_steps=0)
    torch.cuda.synchronize()
    if integ.n_dim != pars.ndim:
        fail("MAOOAM: initialize without number_of_dimensions")
    print("[7] initialize(rng=) without number_of_dimensions, then a sync: "
          "T4, dynamic-T and MAOOAM ok", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "maooam.qgs")
        QgsModel(pars).save(path)
        model = QgsModel.load(path)
    ic = np.random.default_rng(0).random((64, pars.ndim)) * 0.01
    integ = RungeKuttaIntegrator()
    integ.set_func(model.f)
    fused_rk4.launches = fused_df_rk4.launches = k5.launches = 0
    k5.launches_paired = 0
    integ.integrate(0., 100., 0.1, ic=ic, write_steps=10)
    out["qgs_model_launches"] = counts()
    _, traj = integ.get_trajectories()
    _, ref = fused_rk4.fused_rk4_reference(
        model.f.batched, torch.as_tensor(ic, device=dev),
        torch.as_tensor(np.diff(time_grid(0., 100., 0.1)), device=dev), 10)
    out["qgs_model_vs_plain"] = check_close(
        "QgsModel (loaded) integrate B=64 1000 steps vs plain", traj[..., 1:],
        torch.movedim(ref, 0, -1), TOL64)
    print(f"[7] QgsModel(MAOOAM) saved, loaded, integrated: launches "
          f"{out['qgs_model_launches']}", flush=True)
    if out["qgs_model_launches"] != {"rk4_fused": torch.cuda.device_count(),
                                     "rk4_df_fused": 0, "rk4_quartic": 0,
                                     "rk4_paired": 0}:
        fail("the loaded QgsModel did not run through one K1 launch a card")
    stats = TrajectoriesStatistics()
    stats.set_integrator(integ)
    stats.set_func_list([lambda tr: tr[:, :, -1], lambda tr: tr.mean(-1)])
    means = stats.compute_stats(0., 10., 0.1, ic=traj[:, :, -1],
                                write_steps=10, num=4)
    integ.integrate(0., 10., 0.1, ic=traj[:, :, -1], write_steps=10)
    whole = integ.get_trajectories()[1]
    out["statistics_vs_whole"] = check_close(
        "TrajectoriesStatistics (4 batches) vs the whole ensemble", means,
        torch.stack([whole[:, :, -1].mean(0), whole.mean(-1).mean(0)]),
        dict(rtol=0, atol=1e-12))
    if means.device.type != "cuda":
        fail(f"statistics on {means.device}")
    out["seconds"] = time.perf_counter() - start
    print(f"[7] phase 7 took {out['seconds']:.1f} s", flush=True)
    return out


def rp_params(QgParams):
    """The atmosphere-only channel of ``qgs_rp.py`` (ndim 20), with its
    orography and thetas."""
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.2, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    return pars


def ground_params(QgParams):
    """Atmosphere + ground with orography and heat exchange (ndim 30)."""
    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8}, gtemperature_params=True)
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_ground_channel_fourier_modes()
    pars.ground_params.set_orography(0.2, 1)
    return pars


# the diagnostics of an atmosphere (every configuration), of an ocean
# (MAOOAM) and of a ground: (module, class, extra keywords)
ATMOSPHERE_DIAGNOSTICS = [
    ("streamfunctions", "LowerLayerAtmosphericStreamfunctionDiagnostic", {}),
    ("streamfunctions", "UpperLayerAtmosphericStreamfunctionDiagnostic", {}),
    ("streamfunctions", "MiddleAtmosphericStreamfunctionDiagnostic", {}),
    ("temperatures", "MiddleAtmosphericTemperatureAnomalyDiagnostic", {}),
    ("temperatures", "MiddleAtmosphericTemperatureDiagnostic", {}),
    ("temperatures", "AtmosphericTemperatureMeridionalGradientDiagnostic", {}),
    ("temperatures",
     "MiddleAtmosphericTemperatureMeridionalGradientDiagnostic", {}),
    ("wind", "LowerLayerAtmosphericUWindDiagnostic", {}),
    ("wind", "LowerLayerAtmosphericVWindDiagnostic", {}),
    ("wind", "MiddleAtmosphericUWindDiagnostic", {}),
    ("wind", "MiddleAtmosphericVWindDiagnostic", {}),
    ("wind", "UpperLayerAtmosphericUWindDiagnostic", {}),
    ("wind", "UpperLayerAtmosphericVWindDiagnostic", {}),
    ("wind", "LowerLayerAtmosphericWindIntensityDiagnostic", {}),
    ("wind", "MiddleAtmosphericWindIntensityDiagnostic", {}),
    ("wind", "UpperLayerAtmosphericWindIntensityDiagnostic", {}),
    ("wind", "MiddleLayerVerticalVelocity", {}),
    ("vorticity", "LowerLayerAtmosphericVorticityDiagnostic", {}),
    ("vorticity", "MiddleAtmosphericVorticityDiagnostic", {}),
    ("vorticity", "UpperLayerAtmosphericVorticityDiagnostic", {}),
    ("vorticity", "UpperLayerAtmosphericPotentialVorticityDiagnostic", {}),
    ("vorticity", "LowerLayerAtmosphericPotentialVorticityDiagnostic", {}),
    ("eddy", "MiddleAtmosphericEddyHeatFluxDiagnostic", {}),
    ("eddy", "MiddleAtmosphericEddyHeatFluxProfileDiagnostic", {}),
]
OCEAN_DIAGNOSTICS = [
    ("streamfunctions", "OceanicLayerStreamfunctionDiagnostic", {}),
    ("temperatures", "OceanicLayerTemperatureAnomalyDiagnostic", {}),
    ("temperatures", "OceanicLayerTemperatureDiagnostic", {}),
    ("vorticity", "OceanicLayerVorticityDiagnostic", {}),
]
GROUND_DIAGNOSTICS = [
    ("streamfunctions", "MiddleAtmosphericStreamfunctionDiagnostic", {}),
    ("wind", "MiddleLayerVerticalVelocity", {}),
    ("temperatures", "GroundTemperatureAnomalyDiagnostic", {}),
    ("temperatures", "GroundTemperatureDiagnostic", {}),
]
TOL_DIAG = 1e-12       # card against CPU: rtol, and atol x max|CPU field|


def held_bytes(obj, seen):
    """Bytes of the tensors a diagnostic holds (mode grids, point matrices,
    the buffers of its tendency modules), its nested diagnostics' included,
    its data and cached output excluded; ``seen`` skips shared tensors."""
    import torch
    total = 0
    for key, value in vars(obj).items():
        if key in ("_data", "_diagnostic_data"):
            continue
        if torch.is_tensor(value):
            tensors = [value]
        elif isinstance(value, torch.nn.Module):
            tensors = list(value.buffers())
        elif hasattr(value, "_diagnostic_data"):
            total += held_bytes(value, seen)
            tensors = []
        else:
            tensors = []
        for t in tensors:
            if id(t) not in seen:
                seen.add(id(t))
                total += t.numel() * t.element_size()
    return total


def trace_summary(logdir):
    """The window, device-busy share, the fused RK4 kernel's time, the
    top five device operations and the three longest device-idle gaps of
    the ``torch.profiler`` trace in ``logdir``."""
    import glob
    paths = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if len(paths) != 1:
        fail(f"the trace directory holds {len(paths)} trace files")
    with open(paths[0]) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = sorted((e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")), key=lambda e: e["ts"])
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime")]
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    busy, spans = 0.0, []
    for e in device:                    # the union of the device intervals
        a, b = e["ts"], e["ts"] + e["dur"]
        if spans and a <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], b)
        else:
            spans.append([a, b])
    busy = sum(b - a for a, b in spans)
    edges = [start] + [x for s in spans for x in s] + [end]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)),
                  key=lambda g: g[0] - g[1])

    def gap(g0, g1):
        """The gap, the host op that began last before it, and the one
        that overlaps it most."""
        before = [e for e in host if e["ts"] <= g0]
        inside = [(min(e["ts"] + e["dur"], g1) - max(e["ts"], g0), e["name"])
                  for e in host]
        return {"ms": (g1 - g0) / 1e3, "at_ms": (g0 - start) / 1e3,
                "host_op_before": max(before, key=lambda e: e["ts"])["name"]
                if before else None,
                "host_op_during": max(inside)[1]
                if inside and max(inside)[0] > 0 else None}
    totals = {}
    for e in device:
        name = e["name"][:80]
        ms, count = totals.get(name, (0.0, 0))
        totals[name] = (ms + e["dur"] / 1e3, count + 1)
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:5]
    k1 = sum(e["dur"] for e in device if "rk4_fused_kernel" in e["name"])
    window = end - start
    return {"window_ms": window / 1e3, "device_events": len(device),
            "busy_share": busy / window, "rk4_fused_ms": k1 / 1e3,
            "rk4_fused_share": k1 / window,
            "top5_device_ops": [{"name": k, "ms": v[0], "count": v[1]}
                                for k, v in top],
            "idle_ms": (window - busy) / 1e3,
            "longest_idle_gaps": [gap(*g) for g in gaps[:3]]}


def diagnostics_phase(f, ic_main, card, dev):
    """8. The diagnostics on the card: (a) every diagnostic of MAOOAM on a
    20,001-record trajectory of one K1 launch, at the default 100 x 100
    grid, timed, its peak memory and bound, card against CPU on the first
    200 records, and a dashboard drawn on Agg; (b) RP and the ground-coupled
    configuration's own diagnostics, card against CPU; (c) a profiler
    trace and a throughput meter of the float64 main path's call.  Checks
    ``fail`` the run.  Returns the numbers."""
    import torch
    from qgs_tpu_torch.diagnostics import (eddy, multi, streamfunctions,
                                           temperatures, variables,
                                           vorticity, wind)
    from qgs_tpu_torch.params.params import QgParams
    from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
    from qgs_tpu_torch.integrators.rk import time_grid
    from qgs_tpu_torch.models.tendencies import create_tendencies
    from qgs_tpu_torch.ops import fused_df_rk4, fused_rk4
    from qgs_tpu_torch.utils.profiling import ThroughputMeter, trace

    modules = {"streamfunctions": streamfunctions,
               "temperatures": temperatures, "wind": wind,
               "vorticity": vorticity, "eddy": eddy, "variables": variables}
    start = time.perf_counter()
    out = {"card": card}

    def counts():
        return {"rk4_fused": fused_rk4.launches,
                "rk4_df_fused": fused_df_rk4.launches}

    def card_vs_cpu(label, gpu, cpu, t, traj):
        """``gpu`` and ``cpu`` (the same class on each device) on one
        trajectory; returns the largest error over max|CPU field|."""
        got = gpu(t, traj)
        ref = cpu(t, traj.cpu())
        if got.device.type != "cuda" or tuple(got.shape) != tuple(ref.shape):
            fail(f"{label}: {tuple(got.shape)} on {got.device}")
        got = got.cpu()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        if not (torch.isfinite(got).all() and scale > 0 and torch.allclose(
                got, ref, rtol=TOL_DIAG, atol=TOL_DIAG * scale)):
            fail(f"{label}: card against CPU {err:.3e} (max|field| "
                 f"{scale:.3e})")
        return err / scale

    # -- a) MAOOAM: one trajectory of 20,001 records, one K1 launch ---------
    pars = maooam_params(QgParams)
    n = pars.ndim
    ic = np.random.default_rng(8).random(n) * 0.01
    integ = RungeKuttaIntegrator()
    integ.set_func(f)
    fused_rk4.launches = fused_df_rk4.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    integ.integrate(0., 2e4, 0.1, ic=ic, write_steps=10)
    t, traj = integ.get_trajectories()
    torch.cuda.synchronize()
    out["integrate_s"] = s = time.perf_counter() - t0
    nt = len(t)
    print(f"[8] MAOOAM integrate(0, 2e4, 0.1, write_steps=10), one "
          f"trajectory: {s:.3f} s, {nt} records; {card}", flush=True)
    if (tuple(traj.shape) != (n, 20001) or nt != 20001
            or traj.device.type != "cuda" or not torch.isfinite(traj).all()):
        fail(f"diagnosed trajectory {tuple(traj.shape)} on {traj.device}")
    dts = torch.as_tensor(np.diff(time_grid(0., 100., 0.1)), device=dev)
    _, recs = fused_rk4.fused_rk4_reference(f.batched, torch.as_tensor(
        ic, device=dev)[None], dts, 10)
    out["trajectory_vs_plain"] = check_close(
        "diagnosed trajectory, first 101 records vs plain", traj[:, 1:101],
        recs[:, 0].T, TOL64)

    catalog = ATMOSPHERE_DIAGNOSTICS + OCEAN_DIAGNOSTICS + [
        ("variables", "VariablesDiagnostic", {}),
        ("variables", "GeopotentialHeightDifferenceDiagnostic", {})]
    vr = pars.variables_range
    scalars = {"VariablesDiagnostic": [0, vr[0], vr[1], vr[2], n - 1],
               "GeopotentialHeightDifferenceDiagnostic": [
                   ((np.pi / 1.5, np.pi / 4), (np.pi / 1.5, 3 * np.pi / 4))]}
    t200, traj200 = t[:200], traj[:, :200]
    out["each"] = {}
    for module, name, kwargs in catalog:
        cls = getattr(modules[module], name)

        def build(device):
            if name in scalars:
                return cls(scalars[name], pars, device=device)
            return cls(pars, **kwargs, device=device)
        t0 = time.perf_counter()
        d = build(dev)
        setup_s = time.perf_counter() - t0
        # the peak on the first call, before any (inner) output is cached
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        field = d(t, traj)
        torch.cuda.synchronize()
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
        if field.device.type != "cuda" or not torch.isfinite(field).all():
            fail(f"{name}: output on {field.device} or not finite")
        records = field.shape[-1] if name in scalars else field.shape[0]
        if records != nt:
            fail(f"{name}: {records} records, expected {nt}")
        n_bytes = (field.numel() * 8 + traj.numel() * 8
                   + held_bytes(d, set()))
        b_ms, b_by = n_bytes / PEAK_BYTES * 1e3, "bytes"
        del field
        ms = best_ms(lambda: d(t, traj))
        err = card_vs_cpu(name, d, build("cpu"), t200, traj200)
        out["each"][name] = {"ms": ms, "setup_s": setup_s,
                             "peak_mb": peak_mb, "bound_ms": b_ms,
                             "bound_by": b_by, "card_vs_cpu": err}
        if name == "MiddleLayerVerticalVelocity":
            # omega's own device work before its field: the two tendency
            # evaluations over the whole trajectory
            out["each"][name]["set_data_ms"] = sd = best_ms(
                lambda: d.set_data(t, traj))
            print(f"[8] {name}: set_data (f and f_thermo on ({nt}, {n})) "
                  f"{sd:.3f} ms; {card}", flush=True)
        print(f"[8] {name}: {ms:.3f} ms at {nt} records (bound {b_ms:.3f} "
              f"ms, {b_by}; share {b_ms / ms:.3f}), peak {peak_mb:.1f} MB "
              f"above the {base / 2**20:.1f} MB before it, grid set-up "
              f"{setup_s:.3f} s, card vs CPU (200 records) {err:.3e} of "
              f"max|field|; {card}", flush=True)
        del d

    # a dashboard: four fields of one MultiDiagnostic, and one frame of it
    # drawn on Agg where matplotlib is installed (else the frame's host
    # copies alone, which is what a drawn frame moves off the card)
    dash = multi.MultiDiagnostic(2, 2)
    for diag in (streamfunctions.MiddleAtmosphericStreamfunctionDiagnostic,
                 temperatures.MiddleAtmosphericTemperatureDiagnostic,
                 streamfunctions.OceanicLayerStreamfunctionDiagnostic,
                 temperatures.OceanicLayerTemperatureDiagnostic):
        dash.add_diagnostic(diag(pars))
    ms = best_ms(lambda: dash(t, traj))
    t0 = time.perf_counter()
    try:
        import matplotlib
    except ImportError:
        frames = [d.diagnostic[nt - 1].cpu() for d in dash.diagnostics]
        drawn = "not drawn (no matplotlib here); its frames copied to the host"
        if any(tuple(fr.shape) != (100, 100) for fr in frames):
            fail("dashboard frames")
    else:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, _ = dash.plot(time_index=nt - 1)
        fig.canvas.draw()
        plt.close(fig)
        drawn = "drawn on Agg"
    frame_s = time.perf_counter() - t0
    out["dashboard"] = {"ms": ms, "one_frame_s": frame_s, "frame": drawn}
    print(f"[8] MultiDiagnostic 2x2 dashboard: {ms:.3f} ms at {nt} records; "
          f"one frame {drawn} in {frame_s:.3f} s; {card}", flush=True)
    del dash
    out["launches"] = counts()
    print(f"[8] launches across (a): {out['launches']}", flush=True)
    if out["launches"] != {"rk4_fused": 1, "rk4_df_fused": 0}:
        fail("phase 8's integration did not run through one K1 launch")
    ms_each = [v["ms"] for v in out["each"].values()]
    print(f"[8] diagnostics at {nt} records: {min(ms_each):.3f}-"
          f"{max(ms_each):.3f} ms each", flush=True)

    # -- b) RP and the ground-coupled configuration, 301 records ----------
    out["small"] = {}
    for label, settings, catalog_b in (
            ("rp", rp_params, GROUND_DIAGNOSTICS[:2]),
            ("ground", ground_params, GROUND_DIAGNOSTICS)):
        pars_b = settings(QgParams)
        fb, _ = create_tendencies(pars_b)
        ib = RungeKuttaIntegrator()
        ib.set_func(fb)
        ib.integrate(0., 30., 0.1, ic=np.random.default_rng(9).random(
            pars_b.ndim) * 0.05, write_steps=1)
        tb, trb = ib.get_trajectories()
        res = out["small"][label] = {}
        for module, name, kwargs in catalog_b:
            cls = getattr(modules[module], name)
            gpu, cpu = cls(pars_b, **kwargs), cls(pars_b, **kwargs,
                                                  device="cpu")
            if name != "MiddleLayerVerticalVelocity":
                oro = cpu._orography
                if (oro is None or not np.abs(oro).max() > 0
                        or not np.array_equal(gpu._orography, oro)):
                    fail(f"{label} {name}: orography")
            res[name] = card_vs_cpu(f"{label} {name}", gpu, cpu, tb, trb)
        print(f"[8] {label} (ndim {pars_b.ndim}, {len(tb)} records): card vs "
              f"CPU {res} of max|field|; orography a host array, equal", flush=True)

    # -- c) a trace and a throughput meter of the float64 main path's call -
    main = RungeKuttaIntegrator()
    main.set_func(f)

    def main_call():
        main.integrate(0., 1000., 0.1, ic=ic_main, write_steps=100)
        main.get_trajectories()
        torch.cuda.synchronize()
    main_call()
    with tempfile.TemporaryDirectory() as logdir:
        fused_rk4.launches = 0
        with trace(logdir) as written:
            main_call()
        if written != logdir or fused_rk4.launches != \
                torch.cuda.device_count():
            fail("the traced main path did not run through one K1 launch a "
                 "card")
        out["trace"] = summary = trace_summary(logdir)
    print(f"[8] trace of the float64 main path (B=4096, 10000 steps, a "
          f"record every 100): window {summary['window_ms']:.3f} ms, device "
          f"busy {summary['busy_share']:.4f} of it, K1 "
          f"{summary['rk4_fused_ms']:.3f} ms ({summary['rk4_fused_share']:.4f}"
          f"), idle {summary['idle_ms']:.3f} ms; {card}", flush=True)
    for g in summary["longest_idle_gaps"]:
        print(f"  idle gap {g['ms']:.3f} ms at {g['at_ms']:.3f} ms, after "
              f"host op {g['host_op_before']!r}, during "
              f"{g['host_op_during']!r}", flush=True)
    for op in summary["top5_device_ops"]:
        print(f"  device op {op['ms']:.3f} ms x{op['count']}: {op['name']}",
              flush=True)
    meter = ThroughputMeter(n, ensemble=len(ic_main))
    with meter:
        main_call()
    meter.add_steps(10000)
    out["throughput"] = meter.report()
    print(f"[8] ThroughputMeter, the same call: "
          f"{meter.traj_steps_per_s:.4g} traj-steps/s "
          f"({meter.elapsed:.3f} s); {card}", flush=True)
    out["seconds"] = time.perf_counter() - start
    print(f"[8] phase 8 took {out['seconds']:.1f} s", flush=True)
    return out


TOL_SHARD = dict(rtol=1e-12, atol=1e-14)   # split against unsplit


@contextlib.contextmanager
def plain_route():
    """The integrators' plain step loop (plain torch ops) in place of the
    fused kernels, for a reference on the same inputs."""
    from qgs_tpu_torch.integrators import rk
    saved = rk.fused_route
    rk.fused_route = lambda *args: None
    try:
        yield
    finally:
        rk.fused_route = saved


def parallel_phase(f, Df, ic_main, traj_main, card, dev):
    """9. The parallel layer on the card: (a) the integrator's default mesh
    (every visible card) on the float64 main path, against phase 4's call;
    (b) a mesh naming ``cuda:0`` twice, float64 and twofloat at B = 4097,
    against the unsplit calls, timed in turns; (c) TGLS and BLV on that
    mesh; (d) the row-sharded tendency on a 1 x 2 ('ensemble', 'model')
    layout over ``cuda:0``; (e) the two-process self-test over gloo, both
    ranks on ``cuda:0``, and a one-rank NCCL group's gather on the card;
    (f) both drivers' ``main``, run short.  The split runs of (b) and the
    drivers' runs are held against the same calls on the integrator's plain
    route (:func:`plain_route`).  Each path's kernel launches are counted
    from 0.  Checks ``fail`` the run.  Returns the numbers and the launches
    of the paths, by kernel."""
    import io

    import torch
    from qgs_tpu_torch.drivers import qgs_maooam, qgs_rp
    from qgs_tpu_torch.integrators.integrator import (
        RungeKuttaIntegrator, RungeKuttaTglsIntegrator)
    from qgs_tpu_torch.integrators.rk import make_rk_step, rk4_tableau
    from qgs_tpu_torch.ops import fused_df_rk4, fused_rk4
    from qgs_tpu_torch.parallel import distributed
    from qgs_tpu_torch.parallel.mesh import ensemble_mesh, ensemble_size
    from qgs_tpu_torch.parallel.sharded_tendency import make_sharded_tendency
    from qgs_tpu_torch.toolbox.lyapunov import compute_backward_lyapunovs

    start = time.perf_counter()
    out = {"card": card}
    total = {"rk4_fused": 0, "rk4_df_fused": 0}

    def counted(fn):
        """``fn()`` with the launch counts set to 0 before it and read
        after a synchronise; returns its result, seconds and counts."""
        torch.cuda.synchronize()
        fused_rk4.launches = fused_df_rk4.launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        c = {"rk4_fused": fused_rk4.launches,
             "rk4_df_fused": fused_df_rk4.launches}
        for k in total:
            total[k] += c[k]
        return res, time.perf_counter() - t0, c

    def integrate(mesh, precision, ic):
        integ = RungeKuttaIntegrator(mesh=mesh, precision=precision)
        integ.set_func(f)
        integ.integrate(0., 1000., 0.1, ic=ic, write_steps=100)
        return integ.get_trajectories()[1]

    def close(label, got, ref, tol=TOL_SHARD, against="unsplit"):
        got, ref = np.asarray(got.cpu()), np.asarray(ref.cpu())
        if got.shape != ref.shape:
            fail(f"{label}: shapes {got.shape} / {ref.shape}")
        err = float(np.abs(got - ref).max())
        if not np.allclose(got, ref, **tol):
            fail(f"{label}: against {against} {err:.3e} ({tol})")
        return err


    # -- a) the default mesh: every visible card ---------------------------
    n_cards = ensemble_size(ensemble_mesh())
    traj, s, c = counted(lambda: integrate(None, "float64", ic_main))
    print(f"[9a] default mesh: {n_cards} card(s); float64 main path B=4096 "
          f"x 10000 steps {s:.3f} s, launches {c}; {card}", flush=True)
    if c["rk4_fused"] != n_cards:
        fail(f"default mesh: {c['rk4_fused']} K1 launches, expected one a "
             f"card ({n_cards})")
    if not torch.equal(traj, traj_main):
        fail("default mesh: not bit-equal to phase 4's call")
    out["a"] = {"cards": n_cards, "s": s, "launches": c, "bit_equal": True}
    if n_cards > 1:
        # scaling: 4096 members a card, the default mesh against one card,
        # in turns
        ic_n = np.concatenate([ic_main] * n_cards)
        runs = {}
        for key in ("one", "all", "all", "one"):
            mesh = ensemble_mesh([dev]) if key == "one" else None
            res, s, c = counted(lambda: integrate(mesh, "float64", ic_n))
            runs.setdefault(key, []).append((res, s, c))
        if not torch.equal(runs["all"][0][0], runs["one"][0][0]):
            fail("default mesh: not bit-equal to one card")
        ms = {k: [r[1] * 1e3 for r in v] for k, v in runs.items()}
        print(f"[9a] B={len(ic_n)}: {n_cards} cards {min(ms['all']):.3f} "
              f"ms (runs {ms['all']}), one card {min(ms['one']):.3f} ms "
              f"(runs {ms['one']}); bit-equal; {card}", flush=True)
        out["a"]["scaling_ms"] = ms

    # -- b) two entries on cuda:0, B = 4097 (one padded row) ----------------
    two, one = ensemble_mesh([dev, dev]), ensemble_mesh([dev])
    ic = np.random.default_rng(9).random((4097, ic_main.shape[1])) * 0.01
    out["b"] = {}
    with plain_route():
        plain_b = integrate(one, "float64", ic)
    for precision, kernel in (("float64", "rk4_fused"),
                              ("twofloat", "rk4_df_fused")):
        runs = {}
        for mesh in (one, two, two, one):        # in turns
            key = "split" if mesh is two else "whole"
            res, s, c = counted(lambda: integrate(mesh, precision, ic))
            runs.setdefault(key, []).append((res, s, c))
        whole, split = runs["whole"], runs["split"]
        for (_, _, cw), (_, _, cs) in zip(whole, split):
            if cw[kernel] != 1 or cs[kernel] != 2:
                fail(f"two-entry mesh {precision}: {kernel} launches "
                     f"{cs[kernel]} split / {cw[kernel]} whole, expected 2 "
                     "/ 1")
        if not torch.equal(split[0][0], whole[0][0]):
            fail(f"two-entry mesh {precision}: not bit-equal to the "
                 "unsplit call")
        err = close(f"two-entry mesh {precision}", split[0][0], plain_b,
                    TOL64, "the plain float64 route")
        ms = {k: [r[1] * 1e3 for r in v] for k, v in runs.items()}
        print(f"[9b] two entries on {dev}, {precision} B=4097 x 10000 steps: "
              f"split {min(ms['split']):.3f} ms (runs {ms['split']}), whole "
              f"{min(ms['whole']):.3f} ms (runs {ms['whole']}); {kernel} "
              f"2 / 1 launches; bit-equal; split vs plain float64 route "
              f"max err {err:.3e} (rtol 1e-9, atol 1e-11); {card}",
              flush=True)
        out["b"][precision] = {"split_ms": ms["split"],
                               "whole_ms": ms["whole"], "bit_equal": True,
                               "launches_split": 2, "vs_plain": err}

    # -- c) TGLS and BLV on the two-entry mesh ------------------------------
    n = ic_main.shape[1]
    ic_tg = ic_main[:256]
    tg = {}
    for key, mesh in (("whole", one), ("split", two)):
        def tgls():
            integ = RungeKuttaTglsIntegrator(mesh=mesh)
            integ.set_func(f, Df)
            integ.integrate(0., 10., 0.1, ic=ic_tg, tg_ic=np.eye(n),
                            write_steps=50)
            return integ.get_trajectories()
        tg[key] = counted(tgls)
    err_tg = max(close("TGLS", a, b) for a, b in zip(tg["split"][0][1:],
                                                     tg["whole"][0][1:]))
    blv = {}
    for key, mesh in (("whole", one), ("split", two)):
        blv[key] = counted(lambda: compute_backward_lyapunovs(
            f.batched, Df.batched, 0., 0.5, 1.5, 0.1, 0.1, ic_main[:16],
            mesh=mesh))
    err_blv = max(close("BLV", a, b) for a, b in zip(blv["split"][0][1:],
                                                     blv["whole"][0][1:]))
    print(f"[9c] two entries: TGLS B=256 n_tg=36 100 steps split "
          f"{tg['split'][1]:.3f} s / whole {tg['whole'][1]:.3f} s, max err "
          f"{err_tg:.3e}; BLV B=16 15 windows split {blv['split'][1]:.3f} s "
          f"/ whole {blv['whole'][1]:.3f} s, max err {err_blv:.3e} (rtol "
          f"1e-12, atol 1e-14); {card}", flush=True)
    out["c"] = {"tgls_s": [tg["split"][1], tg["whole"][1]],
                "tgls_max_err": err_tg,
                "blv_s": [blv["split"][1], blv["whole"][1]],
                "blv_max_err": err_blv}

    # -- d) the model axis: rows dealt over two entries of cuda:0 -----------
    grid = distributed.host_chip_mesh(2, [dev, dev])
    x = torch.as_tensor(ic_main, device=dev)
    step = make_rk_step(make_sharded_tendency(f.qgtensor.tensor, grid),
                        *rk4_tableau())
    (y, _, c) = counted(lambda: step(x, 0., 0.1))
    y_ref = make_rk_step(f.batched, *rk4_tableau())(x, 0., 0.1)
    err_model = close("row-sharded RK4 step", y, y_ref)
    step_ms = cuda_ms(lambda: step(x, 0., 0.1))
    ref_ms = cuda_ms(lambda: make_rk_step(f.batched, *rk4_tableau())(
        x, 0., 0.1))
    print(f"[9d] model axis {grid.shape} on {dev}: one RK4 step B=4096 "
          f"{step_ms:.3f} ms (unsharded {ref_ms:.3f} ms), max err "
          f"{err_model:.3e}, bit-equal {bool(torch.equal(y, y_ref))}; "
          f"{card}", flush=True)
    out["d"] = {"mesh": grid.shape, "max_err": err_model,
                "bit_equal": bool(torch.equal(y, y_ref)),
                "step_ms": step_ms, "unsharded_step_ms": ref_ms}

    # -- e) two processes on cuda:0 over gloo; a one-rank NCCL group --------
    t0 = time.perf_counter()
    try:
        reports = distributed.run_multiprocess_selftest(
            num_processes=2, model_axis_size=2, device="cuda", timeout=300)
    except RuntimeError as e:
        fail(str(e))
    selftest_s = time.perf_counter() - t0
    for r in reports:
        print(f"[9e] {r}", flush=True)
    if len(reports) != 2 or not all("model-rowshard" in r for r in reports):
        fail(f"selftest reports: {reports}")
    distributed.initialize(f"localhost:{distributed.free_port()}", 1, 0,
                           backend="nccl")
    try:
        backend = str(torch.distributed.get_backend())
        z = torch.arange(4097 * n, dtype=torch.float64, device=dev).reshape(
            4097, n)
        gathered = distributed.gather_to_host(z)
    finally:
        distributed.shutdown()
    if not np.array_equal(gathered, z.cpu().numpy()):
        fail("one-rank NCCL gather_to_host differs")
    print(f"[9e] two-process selftest (gloo, both ranks on {dev}) "
          f"{selftest_s:.1f} s; one-rank {backend} gather_to_host of "
          f"(4097, {n}) on the card ok; {card}", flush=True)
    out["e"] = {"selftest_s": selftest_s, "reports": reports,
                "nccl_gather": backend}

    # -- f) the drivers, run short ------------------------------------------
    # RP is cut to 1e2 + 1e2 time units: over a 1e3 transient its chaos
    # lifts two summation orders' rounding past any tolerance of 1e-10
    out["f"] = {}
    with tempfile.TemporaryDirectory() as d:
        for name, driver, kw, shape in (
                ("qgs_maooam", qgs_maooam,
                 dict(transient_time=1e3, integration_time=1e3,
                      ensemble=1024), (1024, 36, 101)),
                ("qgs_rp", qgs_rp,
                 dict(transient_time=1e2, integration_time=1e2),
                 (201, 21))):
            path = os.path.join(d, f"{name}.dat")
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                (_, traj), s, c = counted(
                    lambda: driver.main(filename=path, **kw))
            with contextlib.redirect_stdout(io.StringIO()), plain_route():
                _, ref = driver.main(filename=os.path.join(d, "plain.dat"),
                                     **kw)
            err = close(f"{name}.main", torch.as_tensor(traj),
                        torch.as_tensor(ref), TOL_DRIVER, "the plain route")
            written = (np.load(path.replace(".dat", ".npy"))
                       if name == "qgs_maooam" else np.loadtxt(path))
            B = shape[0] if name == "qgs_maooam" else 1
            expect = 2 * (n_cards if B >= n_cards > 1 else 1)
            if written.shape != shape or not np.isfinite(written).all():
                fail(f"{name}: wrote {written.shape}, expected {shape}, "
                     "finite")
            if c["rk4_fused"] != expect:
                fail(f"{name}: {c['rk4_fused']} K1 launches, expected "
                     f"{expect}")
            clock = log.getvalue().strip().splitlines()[-1]
            print(f"[9f] {name}.main({kw}): {s:.3f} s (its clock {clock}), "
                  f"K1 {c['rk4_fused']} launches, wrote {written.shape}, "
                  f"vs the plain route max err {err:.3e} (rtol 1e-10, atol "
                  f"1e-12); {card}", flush=True)
            out["f"][name] = {"s": s, "launches": c["rk4_fused"],
                              "shape": list(written.shape), "vs_plain": err}

    out["launches"] = total
    out["phase_s"] = time.perf_counter() - start
    print(f"[9] parallel phase {out['phase_s']:.1f} s; launches {total}; "
          f"{card}", flush=True)
    return out, total


TOL_SYMBOLIC = dict(rtol=1e-8, atol=1e-10)   # exported python vs f, Df
                                             # (tests/test_symbolic_export.py)

# Phase 10 (a): a reference-style MAOOAM script in a child process, with
# jax and the JAX package blocked; the ``qgs`` import block of the
# reference's ``qgs_rp.py``.  Arguments: the repository root and the file
# it saves its trajectories to.  Its last line is one JSON object.
COMPAT_SCRIPT = r'''
import json, sys, time
t_start = time.perf_counter()
sys.modules["jax"] = None          # any import of jax now raises ImportError
sys.modules["qgs_tpu"] = None      # and so does any of the JAX package
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import qgs_tpu_torch.compat
from qgs.params.params import QgParams
from qgs.functions.tendencies import create_tendencies
from qgs.integrators.integrator import RungeKuttaIntegrator
from qgs.ops import fused_df_rk4, fused_rk4
assert fused_rk4 is sys.modules["qgs_tpu_torch.ops.fused_rk4"]

model_parameters = QgParams()
model_parameters.set_atmospheric_channel_fourier_modes(2, 2)
model_parameters.set_oceanic_basin_fourier_modes(2, 4)
model_parameters.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5,
                             'r': 1.e-7, 'h': 136.5, 'd': 1.1e-7})
model_parameters.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3,
                                                 'hlambda': 15.06})
model_parameters.gotemperature_params.set_params({'gamma': 5.6e8,
                                                  'T0': 301.46})
model_parameters.atemperature_params.set_insolation(103.3333, 0)
model_parameters.gotemperature_params.set_insolation(310., 0)
f, Df = create_tendencies(model_parameters)       # on the card by default
torch.cuda.synchronize()
out = {"to_card_s": time.perf_counter() - t_start,
       "device": str(f.batched.device)}
ic = np.random.default_rng(0).random((4096, model_parameters.ndim)) * 0.01
saved = {}
for precision in ("float64", "twofloat"):
    integrator = RungeKuttaIntegrator(precision=precision)
    integrator.set_func(f)
    torch.cuda.synchronize()
    fused_rk4.launches = fused_df_rk4.launches = 0
    t0 = time.perf_counter()
    integrator.integrate(0., 100., 0.1, ic=ic, write_steps=100)
    t, traj = integrator.get_trajectories()
    torch.cuda.synchronize()
    out[precision] = {"s": time.perf_counter() - t0,
                      "rk4_fused": fused_rk4.launches,
                      "rk4_df_fused": fused_df_rk4.launches}
    saved[precision] = traj.cpu().numpy()
    saved[precision + "_t"] = np.asarray(t)
np.savez(sys.argv[2], **saved)
out["leaked"] = sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "qgs_tpu")
                       and sys.modules[m] is not None)
out["s"] = time.perf_counter() - t_start
print(json.dumps(out), flush=True)
'''


def rp_symbolic_params(QgParams):
    """The RP 2x2 channel on a symbolic basis of
    ``tests/test_symbolic_export.py:16-22`` (ndim 20)."""
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
    pars.ground_params.set_orography(0.2, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    return pars


def compat_phase(f, qgt, card, dev):
    """10. The reference-compatibility surface: (a) a reference-style
    MAOOAM script through ``qgs_tpu_torch.compat`` in a child process (jax
    and the JAX package blocked), float64 then twofloat at B = 4096, 1000
    steps of dt 0.1, a record every 100: exactly one K1 and one K2 launch,
    its trajectories bit-equal to the same calls made here through
    ``qgs_tpu_torch`` directly; (b) the port's native C++ oracle built on
    the card's host (timed), its tendency and Jacobian bit for bit the
    NumPy backend's on MAOOAM, and K1's float64 trajectories of 4 members
    over 300 steps against its RK4 (rtol 1e-9, atol 1e-11); (c) the
    symbolic export of the RP 2x2 symbolic configuration in python,
    ``exec``'d and evaluated on 256 states against the port's ``f`` and
    ``Df`` on the card (rtol 1e-8, atol 1e-10).  Checks ``fail`` the run.
    Returns the numbers and the child's launches, by kernel."""
    import math

    import torch
    from qgs_tpu_torch import native
    from qgs_tpu_torch.functions.symbolic_tendencies import (
        create_symbolic_tendencies)
    from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
    from qgs_tpu_torch.integrators.rk import integrate_runge_kutta
    from qgs_tpu_torch.models.numpy_backend import make_numpy_tendencies
    from qgs_tpu_torch.models.tendencies import create_tendencies
    from qgs_tpu_torch.ops import fused_rk4
    from qgs_tpu_torch.params.params import QgParams

    start = time.perf_counter()
    out = {"card": card}
    n = qgt.tensor.shape[0] - 1

    # -- a) the reference-style script in a child process ------------------
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "compat.npz")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", COMPAT_SCRIPT, root,
                               path], cwd=d, capture_output=True, text=True,
                              timeout=600)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"the compat script failed ({proc.returncode}):\n"
                 f"{proc.stderr[-4000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        saved = dict(np.load(path))
    if child["leaked"]:
        fail(f"the compat script imported {child['leaked']}")
    if not child["device"].startswith("cuda"):
        fail(f"the compat script's tendencies are on {child['device']}")
    launches = {"rk4_fused": child["float64"]["rk4_fused"],
                "rk4_df_fused": child["twofloat"]["rk4_df_fused"]}
    expect = {"float64": {"rk4_fused": 1, "rk4_df_fused": 0},
              "twofloat": {"rk4_fused": 0, "rk4_df_fused": 1}}
    for precision, counts in expect.items():
        got = {k: child[precision][k] for k in counts}
        if got != counts:
            fail(f"compat script {precision}: launches {got}, expected "
                 f"{counts}")
    ic = np.random.default_rng(0).random((4096, n)) * 0.01
    out["a"] = {"child_s": child_s, "child": child, "bit_equal": {}}
    for precision in ("float64", "twofloat"):
        integrator = RungeKuttaIntegrator(precision=precision)
        integrator.set_func(f)
        integrator.integrate(0., 100., 0.1, ic=ic, write_steps=100)
        t, traj = integrator.get_trajectories()
        traj = traj.cpu().numpy()
        if traj.shape != (4096, n, 11) or not np.isfinite(traj).all():
            fail(f"direct {precision} run: shape {traj.shape}, finite "
                 f"{np.isfinite(traj).all()}")
        equal = (np.array_equal(saved[precision], traj)
                 and np.array_equal(saved[precision + "_t"], np.asarray(t)))
        if not equal:
            err = float(np.abs(saved[precision] - traj).max())
            fail(f"compat script {precision}: not bit-equal to the direct "
                 f"call (max err {err:.3e})")
        out["a"]["bit_equal"][precision] = True
    print(f"[10a] compat script (child, jax and qgs_tpu blocked): "
          f"{child_s:.1f} s in all, on the card after "
          f"{child['to_card_s']:.1f} s; float64 B=4096 x 1000 steps "
          f"{child['float64']['s'] * 1e3:.3f} ms, twofloat "
          f"{child['twofloat']['s'] * 1e3:.3f} ms; launches {launches}; "
          f"bit-equal to the direct calls; {card}", flush=True)

    # -- b) the native oracle on the card's host ----------------------------
    if not native.available():
        fail("no g++ on the card's host for the native oracle")
    t0 = time.perf_counter()
    try:
        native.load_library()
    except RuntimeError as e:
        fail(str(e))
    build_s = time.perf_counter() - t0
    f_nat, Df_nat = native.make_native_tendencies(qgt.tensor,
                                                  qgt.jacobian_tensor)
    f_np, Df_np = make_numpy_tendencies(qgt.tensor, qgt.jacobian_tensor)
    x = np.random.default_rng(3).random(n) * 0.05
    if not (np.array_equal(f_nat(0., x), f_np(0., x))
            and np.array_equal(Df_nat(0., x), Df_np(0., x))):
        fail("native oracle: tendency or Jacobian not bit-equal to the "
             "NumPy backend")
    x4 = np.random.default_rng(13).random((4, n)) * 0.01
    torch.cuda.synchronize()
    fused_rk4.launches = 0
    _, traj4 = integrate_runge_kutta(f.batched, 0., 30., 0.1, x4,
                                     write_steps=10)
    torch.cuda.synchronize()
    k1_oracle = fused_rk4.launches
    if k1_oracle != 1:
        fail(f"K1 against the oracle: {k1_oracle} launches, expected 1")
    rec = np.stack([native.rk4_integrate(qgt.tensor, xi, 0.1, 300,
                                         write_steps=10)[1].T for xi in x4])
    err_oracle = check_close("K1 float64, 4 members x 300 steps, vs the "
                             "native oracle", traj4, torch.as_tensor(rec),
                             TOL64)
    out["b"] = {"build_s": build_s, "library": native.library_path().name,
                "max_abs_err": err_oracle, "k1_launches": k1_oracle}
    print(f"[10b] native oracle built in {build_s:.2f} s; f/Df bit-equal to "
          f"the NumPy backend; K1 vs oracle max err {err_oracle:.3e}; "
          f"{card}", flush=True)

    # -- c) the symbolic export against f and Df on the card ----------------
    pars = rp_symbolic_params(QgParams)
    t0 = time.perf_counter()
    func_str, jac_str = create_symbolic_tendencies(
        pars, continuation_variables=[], language='python',
        return_jacobian=True)[:2]
    export_s = time.perf_counter() - t0
    ns = {'np': np, 'math': math}
    exec(func_str, ns)
    exec(jac_str, ns)
    fs, Dfs = create_tendencies(pars, device=dev)
    xs = np.random.default_rng(0).random((256, pars.ndim)) * 0.2
    xs_dev = torch.as_tensor(xs, device=dev)
    err_f = check_close("exported python f vs f on the card, 256 states",
                        fs.batched(0., xs_dev),
                        torch.as_tensor(np.stack([ns['f'](0., x)
                                                  for x in xs])),
                        TOL_SYMBOLIC)
    err_j = check_close("exported python jac vs Df on the card, 256 states",
                        Dfs.batched(0., xs_dev),
                        torch.as_tensor(np.stack([ns['jac'](0., x)
                                                  for x in xs])),
                        TOL_SYMBOLIC)
    out["c"] = {"export_s": export_s, "ndim": pars.ndim,
                "f_max_abs_err": err_f, "jac_max_abs_err": err_j,
                "chars": [len(func_str), len(jac_str)]}
    print(f"[10c] symbolic export (RP 2x2 symbolic, python, with Jacobian) "
          f"{export_s:.1f} s on the host; exec'd vs the card max err f "
          f"{err_f:.3e}, Df {err_j:.3e}; {card}", flush=True)

    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - start
    print(f"[10] compat phase {out['phase_s']:.1f} s; launches {launches}; "
          f"{card}", flush=True)
    return out, launches


# the kernels each example launches on the card (the catalog of
# qgs_tpu_torch/examples/__init__.py): each of its set at least once, no
# other (an empty set: none; the host-only and tendency-call examples);
# "rk4_quartic" counts K5's launches over either layout, "rk4_paired" those
# over the paired one
EXAMPLE_KERNELS = {
    "rp_atmosphere": {"rk4_fused"}, "maooam_coupled": {"rk4_fused"},
    "ground_coupled": {"rk4_fused"},
    "precision_tiers": {"rk4_fused", "rk4_df_fused"},
    "external_solvers": {"rk4_fused"}, "lyapunov_exponents": {"rk4_fused"},
    "clv_walkthrough": {"rk4_fused"}, "ensemble_statistics": {"rk4_fused"},
    "distributed_ensembles": {"rk4_fused"},
    "dynamic_temperature": {"rk4_quartic", "rk4_paired"},
    "t4_radiation": {"rk4_quartic", "rk4_paired"},
    "diagnostics_tour": {"rk4_fused"},
    "kernel_selection": {"rk4_fused", "rk4_df_fused"},
    "custom_basis": set(), "symbolic_export": set(),
    "auto_continuation": set()}


def examples_phase(card):
    """11. The 16 examples of ``qgs_tpu_torch.examples`` in their catalog's
    order, each ``main(device="cuda", short=True, plot=False)``
    (``selftest=False`` for ``distributed_ensembles``: phase 9 (e) runs
    that self-test), timed by the host clock after a synchronise, with K1's,
    K2's and K5's launches counted from 0; each held against the same call with
    ``device="cpu"`` at its module's ``TOLERANCES`` (``symbolic_export``,
    host only, has none and is not run twice).  An example whose launches
    differ from :data:`EXAMPLE_KERNELS`, or that disagrees with the CPU,
    ``fail``s the run.  Returns each example's numbers and the launches
    of all of them, by kernel."""
    import importlib

    import torch
    from qgs_tpu_torch import examples
    from qgs_tpu_torch.ops import fused_df_rk4, fused_rk4
    from qgs_tpu_torch.ops import fused_rk4_quartic as k5

    start = time.perf_counter()
    out = {}
    totals = {"rk4_fused": 0, "rk4_df_fused": 0, "rk4_quartic": 0,
              "rk4_paired": 0}
    with tempfile.TemporaryDirectory() as outdir:
        for name in examples.NAMES:
            mod = importlib.import_module(f"qgs_tpu_torch.examples.{name}")
            kw = dict(short=True, plot=False, outdir=outdir)
            if name == "distributed_ensembles":
                kw["selftest"] = False
            torch.cuda.synchronize()
            fused_rk4.launches = fused_df_rk4.launches = k5.launches = 0
            k5.launches_paired = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                got = mod.main(device="cuda", **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {"rk4_fused": fused_rk4.launches,
                        "rk4_df_fused": fused_df_rk4.launches,
                        "rk4_quartic": k5.launches,
                        "rk4_paired": k5.launches_paired}
            for k in totals:
                totals[k] += launches[k]
            need = EXAMPLE_KERNELS[name]
            missed = sorted(k for k in need if launches[k] < 1)
            extra = sorted(k for k in launches
                           if launches[k] and k not in need)
            if missed or extra:
                fail(f"example {name}: launches {launches}, must launch "
                     f"{sorted(need) or 'no kernel'}")
            t0 = time.perf_counter()
            checks = {}
            if mod.TOLERANCES:
                with contextlib.redirect_stdout(io.StringIO()):
                    ref = mod.main(device="cpu", **kw)
                checks = examples.compare(got, ref, mod.TOLERANCES)
            cpu_secs = time.perf_counter() - t0
            bad = sorted(k for k, (_, ok) in checks.items() if not ok)
            gap = max((e for e, _ in checks.values()), default=0.0)
            # the example's own scalars (errors, counts, rates and seconds
            # it measured on the card), beside the numbers held above
            values = {k: v for k, v in got.items() if k not in checks
                      and isinstance(v, (int, float, dict))}
            out[name] = {"seconds": secs, "cpu_seconds": cpu_secs,
                         "launches": launches, "max_abs_err": gap,
                         "max_abs_err_by_key": {k: e for k, (e, _)
                                                in checks.items()},
                         "values": values}
            print(f"[11] {name}: {secs:.3f} s on the card, launches "
                  f"{launches}; against the CPU ({cpu_secs:.1f} s) max abs "
                  f"err {gap:.3e} over {sorted(checks)} "
                  f"{'MISMATCH ' + str(bad) if bad else 'ok'}; {card}",
                  flush=True)
            if bad:
                fail(f"example {name}: the card disagrees with the CPU on "
                     f"{bad}")
    out["launches"] = totals
    out["phase_s"] = time.perf_counter() - start
    out["card"] = card
    print(f"[11] examples phase {out['phase_s']:.1f} s; launches {totals}; "
          f"{card}", flush=True)
    return out, totals


# MAOOAM widths past one block's shared memory (the resolution sweep's
# configurations, ``benchmarks/resolution_sweep.py:60-68``): ndim -> the
# atmosphere's and the ocean's blocks
LARGE_BLOCKS = {36: ((2, 2), (2, 4)), 104: ((4, 4), (4, 4)),
                228: ((6, 6), (6, 6))}


def resolution_params(QgParams, ndim):
    """MAOOAM with ``qgs_maooam.py``'s settings at a wider truncation."""
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(*LARGE_BLOCKS[ndim][0])
    pars.set_oceanic_basin_fourier_modes(*LARGE_BLOCKS[ndim][1])
    pars.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3,
                                         'hlambda': 15.06})
    pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
    pars.atemperature_params.set_insolation(103.3333, 0)
    pars.gotemperature_params.set_insolation(310., 0)
    return pars


# the 12x12 channel atmosphere (ndim 600, 438,449 entries): the benchmark's
# frozen tensor, past the two-buffer streamed K1's shared memory
ATM600 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "portbench", "reference", "tensors", "atm600.npz")
# K1's single-buffer variant against the plain float64 version at ndim 600
# over 100 steps of dt 0.005: only the summation order differs, and these
# steps grow its rounding little (at most 1e-15 of |x| <= 0.1 on the card)
TOL600 = dict(rtol=1e-12, atol=1e-13)


def atmosphere600(card, dev, zero_counts, counts):
    """12 (e'). K1's single-buffer streamed variant on the 12x12 channel
    atmosphere (``ATM600``): the plan's and the route's choice; one
    ``RungeKuttaIntegrator.integrate`` of B = 4096 x 100 steps of dt 0.005
    (a record every 10), its launches counted from 0, and a forced launch
    (a record every 7), each held against the plain float64 version on 64
    members at ``TOL600``; then the variant timed at B = 4096 x 100 steps
    (better of two) beside its bound and the plain version, which runs in
    blocks of 512 members (all 4096 at once would gather 34 GB an operand).
    ``zero_counts`` and ``counts`` are phase 12's.  Returns the numbers and
    the main path's launches, by kernel."""
    import torch
    from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
    from qgs_tpu_torch.integrators.rk import (fused_route, rk4_tableau,
                                              time_grid)
    from qgs_tpu_torch.ops import fused_rk4
    from qgs_tpu_torch.ops.contraction import Tendency

    with np.load(ATM600, allow_pickle=False) as z:
        coords, data, shape = z["coords"], z["data"], tuple(z["shape"])
    f = Tendency(coords, data, shape, device=dev)
    B, n, steps, w, sample = 4096, shape[0] - 1, 100, 10, 64
    y = torch.as_tensor(np.random.default_rng(600).random((B, n)) * 0.01,
                        device=dev)
    kernel = fused_rk4.launch_plan(f, fused_rk4.K1, torch.float64,
                                   dev).kernel
    routed = getattr(fused_route(f, y, rk4_tableau()), "name", None)
    if kernel != "streamed_1buf" or not routed:
        fail(f"ndim {n}: the plan takes {kernel}, fused_route {routed}; "
             "expected the single-buffer streamed K1")

    integrator = RungeKuttaIntegrator()
    integrator.set_func(f)
    torch.cuda.synchronize()
    zero_counts()
    fused_rk4.launches_1buf = 0
    t0 = time.perf_counter()
    integrator.integrate(0., 0.5, 0.005, ic=y.cpu().numpy(), write_steps=w)
    _, traj = integrator.get_trajectories()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = dict(counts(), rk4_streamed_1buf=fused_rk4.launches_1buf)
    if got != {k: int(k in ("rk4_streamed", "rk4_streamed_1buf"))
               for k in got}:
        fail(f"ndim {n} integrate: launches {got}; expected one launch of "
             "the single-buffer streamed K1")
    dts = torch.as_tensor(np.diff(time_grid(0., 0.5, 0.005)), device=dev)
    if (len(dts) != steps or tuple(traj.shape) != (B, n, steps // w + 1)
            or not torch.isfinite(traj).all()):
        fail(f"ndim {n} integrate: {len(dts)} steps, trajectory shape "
             f"{tuple(traj.shape)}, finite {bool(torch.isfinite(traj).all())}")
    y64 = y[:sample]
    _, rr = fused_rk4.fused_rk4_reference(f, y64, dts, w)
    ref = torch.movedim(torch.cat([y64[None], rr]), 0, -1)
    errs = [check_close(f"[12] ndim {n} float64 integrate B={B} x {steps} "
                        f"steps, members 0-{sample - 1}, all records, vs "
                        "plain f64", traj[:sample], ref, TOL600)]
    yk, rk = fused_rk4.K1.launch(f, y64, dts, 7, "streamed_1buf")
    yr, rr = fused_rk4.fused_rk4_reference(f, y64, dts, 7)
    errs += [check_close(f"[12] single-buffer streamed K1 f64 ndim {n} B="
                         f"{sample} {steps} steps final vs plain f64", yk, yr,
                         TOL600),
             check_close(f"[12] single-buffer streamed K1 f64 ndim {n} B="
                         f"{sample} records every 7 vs plain f64", rk, rr,
                         TOL600)]
    del traj, ref, rr, rk

    d = torch.full((steps,), 0.005, dtype=torch.float64, device=dev)
    before = fused_rk4.launches_1buf
    ms = best_ms(lambda: fused_rk4.fused_rk4(f, y, d))
    if fused_rk4.launches_1buf - before != 3:
        fail(f"ndim {n}: {fused_rk4.launches_1buf - before} timed launches "
             "of the single-buffer streamed K1, expected 3")
    plain_ms = cuda_ms(lambda: [fused_rk4.fused_rk4_reference(f, part, d)
                                for part in y.split(512)])
    b_ms, b_by = bound(*rk4_work(B, n, coords, steps, 8), PEAK_FLOPS["f64"])
    torch.cuda.empty_cache()
    out = {"shape": f"B={B} n={n} steps={steps} float64, "
                    f"G={fused_rk4.K1.groups}",
           "kernel": kernel, "fused_route": routed,
           "smem_bytes": fused_rk4.streamed_smem_bytes(n + 1,
                                                       fused_rk4.K1.groups,
                                                       torch.float64, 1),
           "integrate_s": secs, "traj_steps_per_s": B * steps / secs,
           "launches": got, "max_abs_err_vs_plain_f64": errs[0],
           "forced_max_abs_err": max(errs[1:]), "max_abs_err": max(errs),
           "ms": ms, "plain_ms": plain_ms, "plain_block": 512,
           "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms}
    print(f"[12] single-buffer streamed K1 ndim {n} B={B} x {steps} steps: "
          f"integrate {secs * 1e3:.3f} ms, launches {got}; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms (blocks of 512), bound "
          f"{b_ms:.3f} ms ({b_by}), share {b_ms / ms:.4f}; {card}",
          flush=True)
    return out, {"rk4_streamed_1buf": got["rk4_streamed_1buf"]}


def large_models_phase(card, dev):
    """12. Models past one block's shared memory: (a) the Python twins of
    the launchers' shared-memory formulas (``fused_rk4.smem_bytes``,
    ``fused_df_rk4.df_smem_bytes`` and the streamed kernels'
    ``streamed_smem_bytes``, ``df_streamed_smem_bytes``) against the
    compiled ones, at ndim 36, 104 and 228, and the kernel each precision
    takes under the card's opt-in limit; (b) the 4x4/4x4 (ndim 104) paths
    through ``RungeKuttaIntegrator.integrate``: float64 (B = 4096, 1000
    steps) and float32 (B = 4096, 100 steps) through the resident K1, and
    twofloat (B = 1024, 200 steps) through the streamed K2; (c) 6x6/6x6
    (ndim 228) float64 and float32 (B = 1024, 200 steps) through the
    streamed K1; one launch each, ``fused_route`` true, each held in full
    against the plain float64 version on the card (``TOL64``, ``TOL32``
    for float32) and against the CPU on its first 8 members, and timed by
    the host clock.  ``TOL32`` is a tolerance of 100 steps: float32 at
    ndim 228 is held to it over its first 100 steps, and over all 200 to
    the plain float32 version's own gap to float64 (``check_f32_drift``);
    (d) K1 at ndim 104 against ``group_tendency``, its
    plain version in its own summation order, at B = 1, 31 and 4097; the
    streamed kernels forced at ndim 36 (B = 4097, float64, float32,
    twofloat) and 104 (float64, float32), bit-equal to the resident ones;
    the streamed kernels at ndim 228 against their plain versions at B =
    1, 31, 1000; (e) times: K1 alone (float64 and float32, resident and
    streamed) and its plain version at B = 4096 x 1000 steps at ndim 104;
    the streamed kernels and their plain versions at phase 12's shapes (B
    = 1024 x 200 steps), at the resolution sweep's Pallas sizes (ndim 104
    at B = 2048 x 500 steps, ndim 228 at B = 1024 x 100) and at ndim 228
    float64 B = 4096 x 100 (how far the card is filled), each with its
    bound; the float32 kernel's gap to plain float64 every 100 of 1000
    steps; the
    host time of the size check on MAOOAM-36 against ``group_layout``'s;
    (e') K1's single-buffer streamed variant at ndim 600
    (:func:`atmosphere600`);
    (f) forced launches of the resident kernels where they do not fit,
    and launches of a synthetic tensor past every kernel's limit (n1 =
    845, float64 and twofloat), raising.  Checks ``fail`` the run.
    Returns the numbers and the launches of the paths, by kernel."""
    import torch
    from qgs_tpu_torch.params.params import QgParams
    from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
    from qgs_tpu_torch.integrators.rk import (fused_route, rk4_tableau,
                                              time_grid)
    from qgs_tpu_torch.models.tendencies import create_tendencies
    from qgs_tpu_torch.ops import _build, fused_df_rk4, fused_rk4
    from qgs_tpu_torch.ops.contraction import from_numpy
    from qgs_tpu_torch.ops.twofloat import DfTendency, df_from_f64, df_to_f64

    start = time.perf_counter()
    lib = _build.load_library()
    limit = _build.max_smem_optin(dev)
    G = fused_rk4.K1.groups
    props = torch.cuda.get_device_properties(dev)
    sms = props.multi_processor_count
    smem_sm = getattr(props, "shared_memory_per_multiprocessor", None)
    out = {"card": card, "smem_optin_bytes": limit, "sms": sms,
           "smem_per_sm_bytes": smem_sm, "twins": {}}
    print(f"[12] the card's opt-in shared memory a block: {limit} bytes, "
          f"{smem_sm} an SM, {sms} SMs; {card}", flush=True)
    precisions = {"float64": torch.float64, "float32": torch.float32,
                  "twofloat": torch.float32}

    def kernel_of(f, precision):
        family = fused_df_rk4.DF if precision == "twofloat" else fused_rk4.K1
        return fused_rk4.launch_plan(f, family, precisions[precision],
                                     dev).kernel

    # -- a) the twins against the compiled formulas, and the kernels -------
    models = {}
    for ndim in LARGE_BLOCKS:
        pars = resolution_params(QgParams, ndim)
        f, _ = create_tendencies(pars, device=dev)
        f_cpu, _ = create_tendencies(pars, device="cpu")
        models[ndim] = (pars, f, f_cpu)
        fb = f.batched
        n1 = fb.shape[0]
        width = fused_rk4.row_groups(fb.coords, n1, G).width
        twins = {
            "rk4_fused_f64": (fused_rk4.smem_bytes(n1, G, width,
                                                   torch.float64),
                              lib.qgs_rk4_fused_smem_bytes(n1, G, width, 1)),
            "rk4_fused_f32": (fused_rk4.smem_bytes(n1, G, width,
                                                   torch.float32),
                              lib.qgs_rk4_fused_smem_bytes(n1, G, width, 0)),
            "rk4_df_fused": (fused_df_rk4.df_smem_bytes(n1, G, width),
                             lib.qgs_rk4_df_fused_smem_bytes(n1, G, width)),
            "rk4_streamed_f64": (
                fused_rk4.streamed_smem_bytes(n1, G, torch.float64),
                lib.qgs_rk4_streamed_smem_bytes(n1, G, 1)),
            "rk4_streamed_f32": (
                fused_rk4.streamed_smem_bytes(n1, G, torch.float32),
                lib.qgs_rk4_streamed_smem_bytes(n1, G, 0)),
            "rk4_streamed_1buf_f64": (
                fused_rk4.streamed_smem_bytes(n1, G, torch.float64, 1),
                lib.qgs_rk4_streamed_1buf_smem_bytes(n1, G, 1)),
            "rk4_streamed_1buf_f32": (
                fused_rk4.streamed_smem_bytes(n1, G, torch.float32, 1),
                lib.qgs_rk4_streamed_1buf_smem_bytes(n1, G, 0)),
            "rk4_df_streamed": (fused_df_rk4.df_streamed_smem_bytes(n1, G),
                                lib.qgs_rk4_df_streamed_smem_bytes(n1, G))}
        for name, (py, c) in twins.items():
            if py != c:
                fail(f"ndim {ndim} {name}: the Python twin gives {py} bytes, "
                     f"the compiled formula {c}")
        kernels = {p: kernel_of(fb, p) for p in precisions}
        for p, got in kernels.items():
            sfx = {"float64": "_f64", "float32": "_f32", "twofloat": ""}[p]
            resident = ("rk4_df_fused" if p == "twofloat"
                        else "rk4_fused") + sfx
            streamed = ("rk4_df_streamed" if p == "twofloat"
                        else "rk4_streamed") + sfx
            want = ("resident" if twins[resident][0] <= limit else
                    "streamed" if twins[streamed][0] <= limit else None)
            if got != want:
                fail(f"ndim {ndim} {p}: kernel {got}, the bytes say {want}")
        y = torch.zeros((1, ndim), dtype=torch.float64, device=dev)
        routes = {"float64": fused_route(fb, y, rk4_tableau()),
                  "twofloat": fused_route(
                      DfTendency(fb.coords, fb.data, fb.shape, device=dev),
                      df_from_f64(y), rk4_tableau())}
        routes = {k: getattr(v, "name", None) for k, v in routes.items()}
        if not all(routes.values()):
            fail(f"ndim {ndim}: fused_route {routes}, a kernel fits")
        out["twins"][ndim] = {"nnz": len(fb.data), "width": width,
                              "bytes": {k: v[0] for k, v in twins.items()},
                              "kernel": kernels}
        print(f"[12] ndim {ndim}, nnz {len(fb.data)}, width {width}: bytes "
              f"{ {k: v[0] for k, v in twins.items()} } equal to the "
              f"compiled formulas; kernels {kernels}", flush=True)

    names = ("rk4_fused", "rk4_df_fused", "rk4_streamed", "rk4_df_streamed")

    def counts():
        return dict(zip(names, (fused_rk4.launches, fused_df_rk4.launches,
                                fused_rk4.launches_streamed,
                                fused_df_rk4.launches_streamed)))

    def zero_counts():
        fused_rk4.launches = fused_df_rk4.launches = 0
        fused_rk4.launches_streamed = fused_df_rk4.launches_streamed = 0

    def expect(kernel):
        return {k: int(k == kernel) for k in names}

    # -- b, c) the paths through the integrator -----------------------------
    f64_104 = models[104][1]
    f32_104, _ = create_tendencies(models[104][0], dtype=torch.float32,
                                   device=dev)
    f64_228 = models[228][1]
    f32_228, _ = create_tendencies(models[228][0], dtype=torch.float32,
                                   device=dev)
    # name: (ndim, tendency, precision, B, t, write_steps, tolerance, the
    # kernel expected)
    runs = {
        "ndim104_float64": (104, f64_104, "float64", 4096, 100., 100, TOL64,
                            "rk4_fused"),
        "ndim104_float32": (104, f32_104, "float64", 4096, 10., 10, TOL32,
                            "rk4_fused"),
        "ndim104_twofloat": (104, f64_104, "twofloat", 1024, 20., 20, TOL64,
                             "rk4_df_streamed"),
        "ndim228_float64": (228, f64_228, "float64", 1024, 20., 20, TOL64,
                            "rk4_streamed"),
        "ndim228_float32": (228, f32_228, "float64", 1024, 20., 20, TOL32,
                            "rk4_streamed")}
    launches = dict.fromkeys(names, 0)
    plain64 = {}
    for name, (ndim, f, precision, B, t_end, w, tol, kernel) in runs.items():
        ic = np.random.default_rng(ndim).random((B, ndim)) * 0.01
        integrator = RungeKuttaIntegrator(precision=precision)
        integrator.set_func(f)
        y0 = torch.as_tensor(ic, device=dev, dtype=f.batched.dtype)
        state = df_from_f64(y0) if precision == "twofloat" else y0
        fb = (DfTendency(f.batched.coords, f.batched.data, f.batched.shape,
                         device=dev) if precision == "twofloat"
              else f.batched)
        routed = getattr(fused_route(fb, state, rk4_tableau()), "name", None)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        integrator.integrate(0., t_end, 0.1, ic=ic, write_steps=w)
        t, traj = integrator.get_trajectories()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = counts()
        for k in launches:
            launches[k] += got[k]
        if got != expect(kernel) or not routed:
            fail(f"{name}: launches {got}, fused_route {routed}; expected "
                 f"one launch of {kernel}")
        steps = int(round(t_end / 0.1))
        if (tuple(traj.shape) != (B, ndim, steps // w + 1)
                or not torch.isfinite(traj).all()):
            fail(f"{name}: trajectory shape {tuple(traj.shape)}, finite "
                 f"{bool(torch.isfinite(traj).all())}")
        res = out[name] = {"B": B, "steps": steps, "seconds": secs,
                           "traj_steps_per_s": B * steps / secs,
                           "launches": got, "fused_route": routed}
        # the plain float64 version at the same shapes, in full
        key = (ndim, B, t_end, w)
        if key not in plain64:
            dts = torch.as_tensor(np.diff(time_grid(0., t_end, 0.1)),
                                  device=dev)
            y64 = torch.as_tensor(ic, device=dev)
            _, rr = fused_rk4.fused_rk4_reference(models[ndim][1].batched,
                                                  y64, dts, w)
            plain64[key] = (y64, dts, rr)
        y64, dts64, rr = plain64[key]
        ref = torch.movedim(torch.cat([y64[None], rr]), 0, -1)
        # the CPU's run of the first 8 members
        f_cpu = models[ndim][2]
        if name.endswith("float32"):
            f_cpu, _ = create_tendencies(models[ndim][0],
                                         dtype=torch.float32, device="cpu")
        cpu = RungeKuttaIntegrator(precision=precision)
        cpu.set_func(f_cpu)
        cpu.integrate(0., t_end, 0.1, ic=ic[:8], write_steps=w)
        t_cpu, traj_cpu = cpu.get_trajectories()
        if not np.array_equal(np.asarray(t), np.asarray(t_cpu)):
            fail(f"{name}: record times differ from the CPU's")
        if tol is not TOL32 or steps <= 100:
            res["max_abs_err_vs_plain_f64"] = check_close(
                f"[12] {name} B={B} {steps} steps, all records, vs plain "
                "f64", traj, ref, tol)
            res["max_abs_err_vs_cpu"] = check_close(
                f"[12] {name} members 0-7 vs the CPU", traj[:8], traj_cpu,
                tol)
        else:
            # float32 past TOL32's 100 steps: the plain float32 version on
            # the card, the same start and steps, witnesses float32's drift
            _, r32 = fused_rk4.fused_rk4_reference(f.batched, y64.float(),
                                                   dts64, w)
            plain32 = torch.movedim(torch.cat([y64.float()[None], r32]), 0,
                                    -1)
            res["vs_plain_f64"] = check_f32_drift(
                f"[12] {name} B={B}", traj, ref, plain32, w)
            res["max_abs_err_vs_plain_f64"] = \
                res["vs_plain_f64"]["max_abs_err"]
            res["vs_cpu"] = check_f32_drift(
                f"[12] {name} members 0-7 vs the CPU's float32 run", traj[:8],
                ref[:8], traj_cpu, w)
            res["max_abs_err_vs_cpu"] = res["vs_cpu"]["max_abs_err_vs_f32"]
        print(f"[12] {name}: integrate B={B} x {steps} steps in "
              f"{secs * 1e3:.3f} ms ({res['traj_steps_per_s']:.4g} "
              f"traj-steps/s), launches {got}; {card}", flush=True)

    # -- d) the kernels against their plain versions -------------------------
    f104 = f64_104.batched
    layout = fused_rk4.group_layout(f104.coords, f104.data, f104.shape, G)
    dts = torch.as_tensor(np.diff(time_grid(0., 30.05, 0.1)), device=dev)
    dts100 = dts[:100].contiguous()
    errs, errs32 = [], []

    def in_order(t, x):
        return fused_rk4.group_tendency(layout, x)

    for B in (1, 31, 4097):
        yg = torch.as_tensor(np.random.default_rng(B).random((B, 104)) * 0.01,
                             device=dev)
        yr, rr = fused_rk4.fused_rk4_reference(in_order, yg, dts, 7)
        yr100, _ = fused_rk4.fused_rk4_reference(in_order, yg, dts100)
        yk, rk = fused_rk4.fused_rk4(f104, yg, dts, 7)
        errs.append(check_close(f"[12] K1 f64 ndim 104 B={B} 301 steps "
                                "final vs group_tendency", yk, yr, TOL64))
        errs.append(check_close(f"[12] K1 f64 ndim 104 B={B} records every "
                                "7 vs group_tendency", rk, rr, TOL64))
        yk32, _ = fused_rk4.fused_rk4(f32_104.batched, yg.float(), dts100)
        errs32.append(check_close(f"[12] K1 f32 ndim 104 B={B} 100 steps "
                                  "vs f64 group_tendency", yk32, yr100,
                                  TOL32))
    out["k1_max_abs_err"] = max(errs)
    out["k1_f32_max_abs_err"] = max(errs32)

    # the streamed kernels forced where the resident ones run, bit for bit
    # (301 steps with a shorter last one, a record every 7)
    def forced(f, precision, y, d, kernel, w=7):
        if precision == "twofloat":
            fdf = DfTendency(f.coords, f.data, f.shape, device=dev)
            got, recs = fused_df_rk4.DF.launch(fdf, df_from_f64(y), d, w,
                                               kernel)
            return torch.stack(got), torch.stack(recs)
        if precision == "float32":
            f = from_numpy(f.coords, f.data, f.shape, torch.float32, dev)
            y = y.float()
        return fused_rk4.K1.launch(f, y, d, w, kernel)

    bit_equal = {}
    for ndim, precision in ((36, "float64"), (36, "float32"),
                            (36, "twofloat"), (104, "float64"),
                            (104, "float32")):
        B = 4097
        yg = torch.as_tensor(np.random.default_rng(ndim).random((B, ndim))
                             * 0.01, device=dev)
        fb = models[ndim][1].batched
        res_ = forced(fb, precision, yg, dts, "resident")
        got = forced(fb, precision, yg, dts, "streamed")
        same = all(torch.equal(a, b) for a, b in zip(got, res_))
        bit_equal[f"ndim{ndim}_{precision}"] = same
        print(f"[12] streamed == resident, ndim {ndim} {precision} B={B} 301 "
              f"steps, final and records every 7: {same}", flush=True)
        if not same:
            fail(f"the streamed kernel differs from the resident one at ndim "
                 f"{ndim} {precision}")
    out["streamed_bit_equal_to_resident"] = bit_equal

    # the streamed kernels at ndim 228 against their plain versions: float64
    # and float32 against K1's order (group_tendency in float64), twofloat
    # against the plain double-float loop (DfTendency)
    f228 = f64_228.batched
    layout228 = fused_rk4.group_layout(f228.coords, f228.data, f228.shape, G)
    fdf228 = DfTendency(f228.coords, f228.data, f228.shape, device=dev)
    dts50 = dts[:50].contiguous()
    s_errs = {"rk4_streamed": [], "rk4_streamed_f32": [],
              "rk4_df_streamed": []}
    for B in (1, 31, 1000):
        yg = torch.as_tensor(np.random.default_rng(B).random((B, 228)) * 0.01,
                             device=dev)
        yr, rr = fused_rk4.fused_rk4_reference(
            lambda t, x: fused_rk4.group_tendency(layout228, x), yg, dts50, 7)
        yk, rk = forced(f228, "float64", yg, dts50, None)
        s_errs["rk4_streamed"] += [
            check_close(f"[12] streamed K1 f64 ndim 228 B={B} 50 steps final "
                        "vs group_tendency", yk, yr, TOL64),
            check_close(f"[12] streamed K1 f64 ndim 228 B={B} records every 7"
                        " vs group_tendency", rk, rr, TOL64)]
        yk32, _ = forced(f228, "float32", yg, dts50, None)
        s_errs["rk4_streamed_f32"].append(check_close(
            f"[12] streamed K1 f32 ndim 228 B={B} 50 steps vs f64 "
            "group_tendency", yk32, yr, TOL32))
        ydf = df_from_f64(yg)
        (dr, drr) = fused_df_rk4.fused_df_rk4_reference(fdf228, *ydf, dts50,
                                                        7)
        dk, dkr = forced(f228, "twofloat", yg, dts50, None)
        s_errs["rk4_df_streamed"] += [
            check_close(f"[12] streamed K2 ndim 228 B={B} 50 steps final vs "
                        "plain df", df_to_f64(tuple(dk)), df_to_f64(dr),
                        TOL64),
            check_close(f"[12] streamed K2 ndim 228 B={B} records every 7 vs"
                        " plain df", df_to_f64(tuple(dkr)), df_to_f64(drr),
                        TOL64)]
    out["streamed_max_abs_err"] = {k: max(v) for k, v in s_errs.items()}

    # -- e) times ------------------------------------------------------------
    B, steps = 4096, 1000
    yb = torch.as_tensor(np.random.default_rng(2).random((B, 104)) * 0.01,
                         device=dev)
    dts_b = torch.full((steps,), 0.1, dtype=torch.float64, device=dev)
    yb32 = yb.float()
    k64, s64 = [], []
    for kernel in ("resident", "streamed", "streamed", "resident"):
        (k64 if kernel == "resident" else s64).append(cuda_ms(
            lambda: fused_rk4.K1.launch(f104, yb, dts_b, kernel=kernel)))
    k32 = [cuda_ms(lambda: fused_rk4.fused_rk4(f32_104.batched, yb32, dts_b))
           for _ in range(2)]
    plain = cuda_ms(lambda: fused_rk4.fused_rk4_reference(f104, yb, dts_b))
    b64 = bound(*rk4_work(B, 104, f104.coords, steps, 8), PEAK_FLOPS["f64"])
    b32 = bound(*rk4_work(B, 104, f104.coords, steps, 4), PEAK_FLOPS["f32"])
    out["k1_ndim104"] = {
        "shape": f"B={B} n=104 steps={steps}, G={G}",
        "ms": min(k64), "runs_ms": k64, "f32_ms": min(k32), "f32_runs_ms": k32,
        "streamed_ms": min(s64), "streamed_runs_ms": s64,
        "plain_ms": plain, "bound_ms": b64[0], "bound_by": b64[1],
        "share_of_bound": b64[0] / min(k64),
        "streamed_share_of_bound": b64[0] / min(s64), "f32_bound_ms": b32[0],
        "f32_share_of_bound": b32[0] / min(k32)}
    print(f"[12] K1 ndim 104 B={B} {steps} steps: f64 resident {min(k64):.3f}"
          f" ms (runs {k64[0]:.3f}/{k64[1]:.3f}), streamed {min(s64):.3f} ms "
          f"(runs {s64[0]:.3f}/{s64[1]:.3f}), f32 {min(k32):.3f} ms, plain "
          f"f64 {plain:.3f} ms; bound f64 {b64[0]:.3f} ms ({b64[1]}), share "
          f"resident {b64[0] / min(k64):.4f}, streamed {b64[0] / min(s64):.4f}"
          f", f32 {b32[0]:.3f} ms, share {b32[0] / min(k32):.4f}; {card}",
          flush=True)

    # the streamed kernels (and the resident ones where they run) at phase
    # 12's shapes, the resolution sweep's Pallas sizes and B = 4096 at ndim
    # 228: kernel (better of two), plain version (one run), bound, how
    # many blocks the card holds
    def blocks_per_sm(smem):
        return None if smem_sm is None else smem_sm // (smem + 1024)

    timed = {}
    for ndim, precision, B, steps in (
            (104, "twofloat", 1024, 200), (228, "float64", 1024, 200),
            (228, "float32", 1024, 200),
            (104, "float64", 2048, 500), (104, "float32", 2048, 500),
            (104, "twofloat", 2048, 500), (228, "float64", 1024, 100),
            (228, "float32", 1024, 100), (228, "twofloat", 1024, 100),
            (228, "float64", 4096, 100)):
        fb = models[ndim][1].batched
        fk = (from_numpy(fb.coords, fb.data, fb.shape, torch.float32, dev)
              if precision == "float32" else fb)
        y = torch.as_tensor(np.random.default_rng(B).random((B, ndim))
                            * 0.01, device=dev)
        d = torch.full((steps,), 0.1, dtype=torch.float64, device=dev)
        kernel = kernel_of(fb, precision)
        width = fused_rk4.row_groups(fb.coords, ndim + 1, G).width
        if precision == "twofloat":
            fdf = DfTendency(fb.coords, fb.data, fb.shape, device=dev)
            ydf = df_from_f64(y)
            run = lambda: fused_df_rk4.fused_df_rk4(fdf, *ydf, d)
            run_plain = lambda: fused_df_rk4.fused_df_rk4_reference(
                fdf, *ydf, d)
            work = df_rk4_work(B, ndim, fb.coords, steps)
            smem = (fused_df_rk4.df_streamed_smem_bytes(ndim + 1, G)
                    if kernel == "streamed" else fused_df_rk4.df_smem_bytes(
                        ndim + 1, G, width))
        else:
            yk = y.to(fk.dtype)
            run = lambda: fused_rk4.fused_rk4(fk, yk, d)
            run_plain = lambda: fused_rk4.fused_rk4_reference(fk, yk, d)
            work = rk4_work(B, ndim, fb.coords, steps,
                            4 if precision == "float32" else 8)
            smem = (fused_rk4.streamed_smem_bytes(ndim + 1, G, fk.dtype)
                    if kernel == "streamed" else fused_rk4.smem_bytes(
                        ndim + 1, G, width, fk.dtype))
        b_ms, b_by = bound(*work, PEAK_FLOPS["f64" if precision == "float64"
                                             else "f32"])
        before = counts()
        ms = best_ms(run)
        launched = {k: v - before[k] for k, v in counts().items()}
        want = ("rk4_df_" if precision == "twofloat" else "rk4_") + (
            "streamed" if kernel == "streamed" else "fused")
        if launched[want] != 3 or sum(launched.values()) != 3:
            fail(f"ndim {ndim} {precision}: timed launches {launched}, "
                 f"expected 3 of {want}")
        plain_ms = cuda_ms(run_plain)
        # the streamed K1 runs each set of 32 as a cluster of the plan's c
        cluster = (fused_rk4.launch_plan(fk, fused_rk4.K1, fk.dtype,
                                         yk.device).cluster
                   if want == "rk4_streamed" else 1)
        blocks = -(-B // 32) * cluster
        per_sm = blocks_per_sm(smem)
        row = timed[f"ndim{ndim}_{precision}_B{B}_x{steps}"] = {
            "kernel": want, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "share_of_bound": b_ms / ms,
            "smem_bytes": smem, "blocks": blocks, "cluster": cluster,
            "blocks_per_sm": per_sm, "sms_busy_share": min(blocks, sms) / sms}
        print(f"[12] {want} ndim {ndim} {precision} B={B} x {steps} steps: "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
              f"({b_by}), share {b_ms / ms:.4f}; {blocks} blocks of {smem} B "
              f"(clusters of {cluster}, {per_sm} an SM) on {sms} SMs; {card}",
              flush=True)
    out["times"] = timed

    # the float32 kernel's gap to float64 along 1000 steps at ndim 104 (the
    # float64 path's start and plain records; held at TOL32 over 100 steps
    # above, reported past them)
    y0, dts, rr = plain64[(104, 4096, 100., 100)]
    _, r32 = fused_rk4.fused_rk4(f32_104.batched, y0.float(), dts, 100)
    growth = [float((a.double() - b).abs().max()) for a, b in zip(r32, rr)]
    out["k1_f32_gap_every_100_steps"] = growth
    print(f"[12] K1 f32 ndim 104 B={y0.shape[0]}: max gap to plain f64 every "
          f"100 steps {', '.join(f'{g:.3e}' for g in growth)}; {card}",
          flush=True)

    # the route's host time on MAOOAM-36 (a launch plan's look-up a call),
    # against the layout that a plan's first launch builds
    f36 = models[36][1].batched
    t0 = time.perf_counter()
    for _ in range(1000):
        fused_rk4.launch_plan(f36, fused_rk4.K1, torch.float64, dev).kernel
    fits_us = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(100):
        fused_rk4.group_layout(f36.coords, f36.data, f36.shape, G)
    layout_us = (time.perf_counter() - t0) * 1e4
    out["host_us"] = {"launch_plan_ndim36": fits_us,
                      "group_layout_ndim36": layout_us}
    print(f"[12] host time a call on ndim 36: launch_plan {fits_us:.1f} us,"
          f" group_layout {layout_us:.1f} us; {card}", flush=True)

    out["k1_1buf"], launches_1buf = atmosphere600(card, dev, zero_counts,
                                                  counts)
    for k, v in launches_1buf.items():
        launches[k] = launches.get(k, 0) + v

    # -- f) launches that cannot run raise ---------------------------------
    before = counts()
    n1 = 845                      # past every kernel's float64 limit
    i = np.arange(1, n1)
    coords = np.stack([i, i, np.zeros_like(i)])
    big = from_numpy(coords, np.full(n1 - 1, -0.01), (n1,) * 3,
                     torch.float64, dev)
    big_df = DfTendency(coords, np.full(n1 - 1, -0.01), (n1,) * 3,
                        device=dev)
    y845 = torch.zeros((32, n1 - 1), dtype=torch.float64, device=dev)
    ydf = df_from_f64(yb[:32].contiguous())
    fdf104 = DfTendency(f104.coords, f104.data, f104.shape, device=dev)
    y228 = torch.zeros((32, 228), dtype=torch.float64, device=dev)
    for name, call, match in (
            ("resident K2 ndim 104", lambda: fused_df_rk4.DF.launch(
                fdf104, ydf, dts_b[:4], kernel="resident"),
             "rk4_df_fused launch failed"),
            ("resident K1 f64 ndim 228", lambda: fused_rk4.K1.launch(
                f228, y228, dts_b[:4], kernel="resident"),
             "rk4_fused launch failed"),
            ("K1 f64 n1 845", lambda: fused_rk4.fused_rk4(
                big, y845, dts_b[:4]), "neither the resident"),
            ("K2 n1 845", lambda: fused_df_rk4.fused_df_rk4(
                big_df, *df_from_f64(y845), dts_b[:4]), "neither the resident"),
            ("streamed K1 f64 n1 845", lambda: fused_rk4.K1.launch(
                big, y845, dts_b[:4], kernel="streamed"),
             "rk4_streamed launch failed"),
            ("single-buffer streamed K1 f64 n1 845",
             lambda: fused_rk4.K1.launch(big, y845, dts_b[:4],
                                         kernel="streamed_1buf"),
             "rk4_streamed_1buf launch failed")):
        try:
            call()
        except RuntimeError as err:
            if match not in str(err):
                fail(f"a direct {name} launch raised {err}")
            print(f"[12] direct {name} raised as it must: {err}", flush=True)
        else:
            fail(f"a direct {name} launch did not raise")
    if counts() != before:
        fail("a refused launch was counted")
    if fused_route(big, y845, rk4_tableau()):
        fail("fused_route sends a tensor past both kernels to a kernel")
    out["phase_s"] = time.perf_counter() - start
    out["launches"] = launches
    print(f"[12] large models phase {out['phase_s']:.1f} s; launches "
          f"{launches}; {card}", flush=True)
    return out, launches


# Phase 13: the long-horizon climate gate (the port's counterpart of
# ``tests/test_fidelity_longrun.py`` and ``benchmarks/fidelity.py``).  Chaos
# rules out comparing points over 120,000 steps, so the run is held to the
# native float64 oracle's climate: per-variable means and stds, and the
# dominant spectral bin.  The tolerances are the ones
# ``benchmarks/fidelity.py`` records.
FIDELITY_STEPS = 120_000
FIDELITY_MEMBERS = 4
FIDELITY_WRITE = 10
TOL_FIDELITY_POINTWISE = dict(rtol=5e-7, atol=5e-9)   # the first 5 records


def attractor_ensemble(tensor, ndim, n_members, transient_steps=200_000,
                       spacing_steps=20_000, dt=0.1):
    """Decorrelated initial conditions on the attractor, (n_members, ndim),
    from one long trajectory of the port's native float64 oracle: a seeded
    start (``default_rng(42)``), a transient, then ``spacing_steps``
    between members."""
    from qgs_tpu_torch import native

    rng = np.random.default_rng(42)
    y = rng.random(ndim) * 0.01
    y, _ = native.rk4_integrate(tensor, y, dt, transient_steps)
    ics = []
    for _ in range(n_members):
        y, _ = native.rk4_integrate(tensor, y, dt, spacing_steps)
        ics.append(y.copy())
    return np.asarray(ics)


def run_oracle(tensor, ics, n_steps, write_steps, dt=0.1):
    """The native oracle's trajectories of ``ics``, (B, n_records, ndim)."""
    from qgs_tpu_torch import native

    return np.asarray([native.rk4_integrate(tensor, ic, dt, n_steps,
                                            write_steps=write_steps)[1]
                       for ic in ics])


def climate_stats(recs, burn_frac=0.1):
    """Per-variable mean and std pooled over members and time, after the
    first ``burn_frac`` of the records."""
    burn = int(recs.shape[1] * burn_frac)
    flat = recs[:, burn:, :].reshape(-1, recs.shape[-1])
    return flat.mean(axis=0), flat.std(axis=0)


def psd_peak(recs, var=0, dt_rec=1.0):
    """The dominant nonzero-frequency bin of one variable's power spectrum,
    averaged over members: ``(frequency, bin)``."""
    x = recs[:, :, var]
    x = x - x.mean(axis=1, keepdims=True)
    psd = (np.abs(np.fft.rfft(x, axis=1)) ** 2).mean(axis=0)
    freqs = np.fft.rfftfreq(x.shape[1], d=dt_rec)
    k = 1 + int(np.argmax(psd[1:]))
    return freqs[k], k


def compare_climate(oracle, device):
    """The gate's metrics of ``device``'s records against ``oracle``'s,
    both (B, n_records, ndim): the largest mean deviation in units of the
    oracle's std, the range of the std ratio over the active variables
    (std above 1e-3 of the largest), and both dominant PSD bins."""
    mo, so = climate_stats(oracle)
    md, sd = climate_stats(device)
    mean_dev = np.abs(md - mo) / np.maximum(so, 1e-12)
    active = so > 1e-3 * so.max()
    std_ratio = sd[active] / so[active]
    _, ko = psd_peak(oracle)
    _, kd = psd_peak(device)
    return {"max_mean_dev_in_std": float(mean_dev.max()),
            "max_std_ratio": float(std_ratio.max()),
            "min_std_ratio": float(std_ratio.min()),
            "psd_peak_oracle_bin": int(ko),
            "psd_peak_device_bin": int(kd)}


def check_metrics(metrics, mean_tol=0.1, std_lo=0.8, std_hi=1.25,
                  psd_bins=1):
    """The tolerances that ``metrics`` break (an empty list when it meets
    them all)."""
    broken = []
    if not metrics["max_mean_dev_in_std"] <= mean_tol:
        broken.append(f"mean deviation {metrics['max_mean_dev_in_std']} > "
                      f"{mean_tol} std")
    if not std_lo <= metrics["min_std_ratio"]:
        broken.append(f"std ratio {metrics['min_std_ratio']} < {std_lo}")
    if not metrics["max_std_ratio"] <= std_hi:
        broken.append(f"std ratio {metrics['max_std_ratio']} > {std_hi}")
    if not abs(metrics["psd_peak_device_bin"]
               - metrics["psd_peak_oracle_bin"]) <= psd_bins:
        broken.append(f"PSD bin {metrics['psd_peak_device_bin']} more than "
                      f"{psd_bins} from {metrics['psd_peak_oracle_bin']}")
    return broken


def fidelity_phase(card, dev):
    """13. The long-horizon climate gate on MAOOAM (``qgs_maooam.py``'s
    settings, ndim 36): 4 attractor members from the port's native float64
    oracle (a 200,000-step transient from ``default_rng(42)``, 20,000 steps
    between members), then 120,000 steps of dt 0.1 with a record every 10
    steps by the oracle and by ``RungeKuttaIntegrator.integrate`` on the
    card: twofloat (one K2 launch), float64 (one K1 launch) and float32
    (the tendency built in float32, one K1 launch).  Twofloat and float64
    must match the oracle pointwise on the first 5 records (rtol 5e-7,
    atol 5e-9), stay finite, and meet the climate tolerances of
    ``benchmarks/fidelity.py`` (mean deviation at most 0.1 std, std ratio
    of the active variables in [0.8, 1.25], dominant PSD bin within one
    bin).  float32 is gated on finiteness only: the JAX package has no
    float32 climate gate, and a tolerance chosen after seeing the card's
    numbers would be no gate; its metrics are printed.  Checks ``fail``
    the run.  Returns the numbers and the launches, by kernel."""
    import torch
    from qgs_tpu_torch.params.params import QgParams
    from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
    from qgs_tpu_torch.models.tendencies import create_tendencies
    from qgs_tpu_torch.ops import fused_df_rk4, fused_rk4

    start = time.perf_counter()
    pars = maooam_params(QgParams)
    n = pars.ndim
    f, _, qgt = create_tendencies(pars, return_qgtensor=True, device=dev)
    f32, _ = create_tendencies(pars, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    ics = attractor_ensemble(qgt.tensor, n, FIDELITY_MEMBERS)
    ics_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = run_oracle(qgt.tensor, ics, FIDELITY_STEPS, FIDELITY_WRITE)
    oracle_s = time.perf_counter() - t0
    n_rec = FIDELITY_STEPS // FIDELITY_WRITE + 1
    if oracle.shape != (FIDELITY_MEMBERS, n_rec, n):
        fail(f"[13] oracle records {oracle.shape}")
    out = {"card": card, "members": FIDELITY_MEMBERS,
           "steps": FIDELITY_STEPS, "write_steps": FIDELITY_WRITE,
           "oracle": {"ics_s": ics_s, "s": oracle_s,
                      "steps": FIDELITY_MEMBERS * FIDELITY_STEPS + 200_000
                      + FIDELITY_MEMBERS * 20_000}}
    print(f"[13] native oracle: {FIDELITY_MEMBERS} attractor members in "
          f"{ics_s:.2f} s, {FIDELITY_MEMBERS} x {FIDELITY_STEPS} steps in "
          f"{oracle_s:.2f} s (host)", flush=True)
    # precision: (tendency, integrator precision, the launches expected,
    # gated on the climate)
    runs = {"twofloat": (f, "twofloat", {"rk4_fused": 0, "rk4_df_fused": 1},
                         True),
            "float64": (f, "float64", {"rk4_fused": 1, "rk4_df_fused": 0},
                        True),
            "float32": (f32, "float64", {"rk4_fused": 1, "rk4_df_fused": 0},
                        False)}
    launches = {"rk4_fused": 0, "rk4_df_fused": 0}
    for name, (fn, precision, expect, gated) in runs.items():
        integrator = RungeKuttaIntegrator(precision=precision)
        integrator.set_func(fn)
        torch.cuda.synchronize()
        fused_rk4.launches = fused_df_rk4.launches = 0
        t0 = time.perf_counter()
        integrator.integrate(0., FIDELITY_STEPS * 0.1, 0.1, ic=ics,
                             write_steps=FIDELITY_WRITE)
        t, traj = integrator.get_trajectories()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {"rk4_fused": fused_rk4.launches,
               "rk4_df_fused": fused_df_rk4.launches}
        for k in launches:
            launches[k] += got[k]
        if got != expect:
            fail(f"[13] {name}: launches {got}, expected {expect}")
        recs = torch.movedim(traj, -1, 1).double().cpu().numpy()
        if recs.shape != oracle.shape or len(t) != n_rec:
            fail(f"[13] {name}: records {recs.shape}, oracle {oracle.shape}")
        finite = bool(np.isfinite(recs).all())
        head = float(np.abs(recs[:, :5] - oracle[:, :5]).max())
        every = float(np.abs(recs - oracle).max())
        metrics = compare_climate(oracle, recs)
        out[name] = {"s": secs, "launches": got, "finite": finite,
                     "first_5_records_max_abs_err": head,
                     "all_records_max_abs_err": every,
                     "traj_steps_per_s":
                         FIDELITY_MEMBERS * FIDELITY_STEPS / secs,
                     "gated": gated, **metrics}
        print(f"[13] {name}: {FIDELITY_MEMBERS} x {FIDELITY_STEPS} steps in "
              f"{secs:.3f} s, launches {got}; finite {finite}; first 5 "
              f"records vs oracle {head:.3e}, all records {every:.3e} "
              f"(not gated); mean deviation "
              f"{metrics['max_mean_dev_in_std']:.4f} std, std ratio "
              f"[{metrics['min_std_ratio']:.4f}, "
              f"{metrics['max_std_ratio']:.4f}], PSD bin oracle "
              f"{metrics['psd_peak_oracle_bin']} / "
              f"{metrics['psd_peak_device_bin']}; "
              f"{'gated' if gated else 'printed, gated on finiteness'}; "
              f"{card}", flush=True)
        if not finite:
            fail(f"[13] {name}: non-finite records")
        if gated:
            if not np.allclose(recs[:, :5], oracle[:, :5],
                               **TOL_FIDELITY_POINTWISE):
                fail(f"[13] {name}: first 5 records {head:.3e} from the "
                     f"oracle (rtol {TOL_FIDELITY_POINTWISE['rtol']}, atol "
                     f"{TOL_FIDELITY_POINTWISE['atol']})")
            broken = check_metrics(metrics)
            if broken:
                fail(f"[13] {name}: climate against the oracle: "
                     f"{'; '.join(broken)}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - start
    print(f"[13] fidelity phase {out['phase_s']:.1f} s; launches "
          f"{launches}; {card}", flush=True)
    return out, launches


def main():
    # -- 1. device ---------------------------------------------------------
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    try:
        from qgs_tpu_torch.params.params import QgParams
        from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
        from qgs_tpu_torch.integrators.rk import (integrate_runge_kutta,
                                                  integrate_runge_kutta_df,
                                                  time_grid)
        from qgs_tpu_torch.models.tendencies import create_tendencies
        from qgs_tpu_torch.ops import _build, fused_df_rk4, fused_rk4
        from qgs_tpu_torch.ops.contraction import from_numpy
        from qgs_tpu_torch.ops.twofloat import (DfTendency, df_from_f64,
                                                df_to_f64)
    except ImportError as e:
        fail(f"the qgs_tpu_torch package is not beside this script: {e}")

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi could not read the card's name and power limit: {e}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {kind} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(card, flush=True)
    dev = torch.device("cuda", 0)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[2] build: {' + '.join(_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print("  ptxas:", line.strip(), flush=True)

    # -- 3. kernel against its plain version -------------------------------
    pars = maooam_params(QgParams)
    f, Df, qgt = create_tendencies(pars, return_qgtensor=True, device="cuda")
    coo = qgt.tensor
    n = pars.ndim
    f64 = f.batched
    f32 = from_numpy(coo.coords, coo.data, coo.shape, torch.float32, dev)
    print(f"[3] kernel vs plain: MAOOAM ndim {n}, nnz {coo.nnz}", flush=True)

    grid = time_grid(0., 30.05, 0.1)                 # shorter last step
    dts = torch.as_tensor(np.diff(grid), device=dev)
    dts100 = dts[:100].contiguous()
    errs64, errs32 = [], []
    for B in (1, 31, 1000, 4097):                    # ragged last blocks
        yg = torch.as_tensor(np.random.default_rng(B).random((B, n)) * 0.01,
                             device=dev)
        yr, rr = fused_rk4.fused_rk4_reference(f64, yg, dts, 7)
        yr100, _ = fused_rk4.fused_rk4_reference(f64, yg, dts100, 0)
        for G in GROUPS_TRIED:
            yk, rk = at_groups(fused_rk4.K1, f64, yg, dts, 7, G)
            errs64.append(check_close(f"f64 G={G} B={B} 301 steps final", yk,
                                      yr, TOL64))
            errs64.append(check_close(f"f64 G={G} B={B} records every 7", rk,
                                      rr, TOL64))
            yk32, _ = at_groups(fused_rk4.K1, f32, yg.float(), dts100, 0, G)
            errs32.append(check_close(f"f32 G={G} B={B} 100 steps vs f64 "
                                      "plain", yk32, yr100, TOL32))
    y0 = torch.as_tensor(np.random.default_rng(1).random((1000, n)) * 0.01,
                         device=dev)

    tk, trk = integrate_runge_kutta(f64, 0., 30.05, 0.1, y0, write_steps=7)
    tp, trp = integrate_runge_kutta(lambda t, x: f64(t, x), 0., 30.05, 0.1,
                                    y0, write_steps=7)
    if not np.array_equal(tk, tp):
        fail("integrator record times differ between kernel and plain route")
    check_close("integrate(0, 30.05, 0.1, write_steps=7)", trk, trp, TOL64)
    tk, trk = integrate_runge_kutta(f64, 0., 30.05, 0.1, y0, write_steps=7,
                                    forward=False)
    tp, trp = integrate_runge_kutta(lambda t, x: f64(t, x), 0., 30.05, 0.1,
                                    y0, write_steps=7, forward=False)
    if not np.array_equal(tk, tp):
        fail("backward record times differ between kernel and plain route")
    check_close("integrate backward", trk, trp, TOL64)

    # the double-float kernel for every G (one plain run a B), and
    # integrate_runge_kutta_df's kernel route against its plain route (a
    # function that carries no tensor), forward and backward
    fdf = DfTendency(coo.coords, coo.data, coo.shape, device=dev)
    errs_df = []
    for B in (1, 31, 1000, 4097):
        ydf = df_from_f64(torch.as_tensor(
            np.random.default_rng(B).random((B, n)) * 0.01, device=dev))
        yr, rr = fused_df_rk4.fused_df_rk4_reference(fdf, *ydf, dts, 7)
        for G in GROUPS_TRIED:
            yk, rk = at_groups(fused_df_rk4.DF, fdf, ydf, dts, 7, G)
            errs_df.append(check_close(f"df G={G} B={B} 301 steps final",
                                       df_to_f64(yk), df_to_f64(yr), TOL64))
            errs_df.append(check_close(f"df G={G} B={B} records every 7",
                                       df_to_f64(rk), df_to_f64(rr), TOL64))
    for forward in (True, False):
        tk, trk = integrate_runge_kutta_df(fdf, 0., 30.05, 0.1, y0,
                                           write_steps=7, forward=forward)
        tp, trp = integrate_runge_kutta_df(lambda h, lo: fdf(h, lo), 0.,
                                           30.05, 0.1, y0, write_steps=7,
                                           forward=forward)
        if not np.array_equal(tk, tp):
            fail("twofloat record times differ between kernel and plain "
                 "route")
        errs_df.append(check_close(
            f"integrate_runge_kutta_df(0, 30.05, 0.1, write_steps=7, "
            f"forward={forward})", trk, trp, TOL64))
    err_df = max(errs_df)

    # the main path's shapes: B = 4096, the 10000-step grid, a record every 100
    ic = np.random.default_rng(0).random((4096, n)) * 0.01
    ic_dev = torch.as_tensor(ic, device=dev)
    dts_main = torch.as_tensor(np.diff(time_grid(0., 1000., 0.1)), device=dev)
    yk, rk = fused_rk4.fused_rk4(f64, ic_dev, dts_main, 100)
    yr, rr = fused_rk4.fused_rk4_reference(f64, ic_dev, dts_main, 100)
    errs64.append(check_close("f64 B=4096 10000 steps final", yk, yr, TOL64))
    errs64.append(check_close("f64 B=4096 records every 100", rk, rr, TOL64))
    # the plain float64 trajectory of the whole main-path ensemble, which
    # the main paths of both precisions are held against in full
    traj_ref = torch.movedim(torch.cat([ic_dev[None], rr]), 0, -1)

    # -- 4. the main path: f, Df from create_tendencies(device="cuda") above
    tp, trp = integrate_runge_kutta(lambda tt, x: f.batched(tt, x), 0.,
                                    1000., 0.1, ic_dev[:8], write_steps=100)
    launches, err_main, main_s, main_traj = {}, {}, {}, {}
    for precision, kernel in (("float64", "rk4_fused"),
                              ("twofloat", "rk4_df_fused")):
        integrator = RungeKuttaIntegrator(precision=precision)
        integrator.set_func(f)
        torch.cuda.synchronize()
        fused_rk4.launches = fused_df_rk4.launches = 0
        t0 = time.perf_counter()
        integrator.integrate(0., 1000., 0.1, ic=ic, write_steps=100)
        t, traj = integrator.get_trajectories()
        torch.cuda.synchronize()
        main_s[precision] = time.perf_counter() - t0
        counts = {"rk4_fused": fused_rk4.launches,
                  "rk4_df_fused": fused_df_rk4.launches}
        launches[kernel] = counts[kernel]
        print(f"[4] main path {precision}: integrate(0, 1000, 0.1, B=4096, "
              f"write_steps=100) in {main_s[precision]:.3f} s, launches "
              f"{counts}",
              flush=True)
        if counts[kernel] < 1:
            fail(f"the {precision} main path did not launch {kernel}")
        if tuple(traj.shape) != (4096, n, 101) or traj.device.type != "cuda":
            fail(f"trajectory shape {tuple(traj.shape)} on {traj.device}, "
                 f"expected (4096, {n}, 101) on cuda")
        if traj.dtype != torch.float64:
            fail(f"{precision} trajectory dtype {traj.dtype}")
        if not torch.isfinite(traj).all():
            fail("non-finite values in the trajectory")
        if len(t) != 101 or t[0] != 0. or t[-1] != 1000.:
            fail(f"record times {t[:3]}...{t[-3:]}")
        if not np.array_equal(t, tp):
            fail("main path record times differ from the plain path")
        err_8 = check_close(f"{precision} main path members 0-7 vs plain f64 "
                            "path", traj[:8], trp, TOL64)
        err_all = check_close(f"{precision} main path, all 4096 members and "
                              "101 records, vs plain f64 fused_rk4_reference",
                              traj, traj_ref, TOL64)
        err_main[precision] = (err_8, err_all)
        main_traj[precision] = traj

    # -- 5. times ----------------------------------------------------------
    B, steps = 16384, 1000
    yb = torch.as_tensor(np.random.default_rng(2).random((B, n)) * 0.01,
                         device=dev)
    dts_b = torch.full((steps,), 0.1, dtype=torch.float64, device=dev)
    times = {}
    yb32, ybdf = yb.float(), df_from_f64(yb)
    runs = {
        "f64": (lambda d: fused_rk4.fused_rk4(f64, yb, d),
                lambda d: fused_rk4.fused_rk4_reference(f64, yb, d)),
        "f32": (lambda d: fused_rk4.fused_rk4(f32, yb32, d),
                lambda d: fused_rk4.fused_rk4_reference(f32, yb32, d)),
        "df": (lambda d: fused_df_rk4.fused_df_rk4(fdf, *ybdf, d),
               lambda d: fused_df_rk4.fused_df_rk4_reference(fdf, *ybdf, d)),
    }
    bounds = {
        "f64": bound(*rk4_work(B, n, coo.coords, steps, 8),
                     PEAK_FLOPS["f64"]),
        "f32": bound(*rk4_work(B, n, coo.coords, steps, 4),
                     PEAK_FLOPS["f32"]),
        # double-float runs in float32 operations
        "df": bound(*df_rk4_work(B, n, coo.coords, steps), PEAK_FLOPS["f32"])}
    for name, (run_kernel, run_plain) in runs.items():
        run_kernel(dts_b[:10])                                   # warm-up
        run_plain(dts_b[:10])
        plain1 = cuda_ms(lambda: run_plain(dts_b))
        kern1 = cuda_ms(lambda: run_kernel(dts_b))
        kern2 = cuda_ms(lambda: run_kernel(dts_b))
        plain2 = cuda_ms(lambda: run_plain(dts_b))
        kern, plain = min(kern1, kern2), min(plain1, plain2)
        times[name] = (kern, plain)
        print(f"[5] {name} B={B} {steps} steps: kernel {kern:.3f} ms "
              f"({B * steps / kern * 1e3:.4g} traj-steps/s), plain "
              f"{plain:.3f} ms ({B * steps / plain * 1e3:.4g} traj-steps/s); "
              f"runs kernel {kern1:.3f}/{kern2:.3f}, plain "
              f"{plain1:.3f}/{plain2:.3f} ms; bound {bounds[name][0]:.3f} ms "
              f"({bounds[name][1]}), share of bound "
              f"{bounds[name][0] / kern:.4f}; {card}", flush=True)

    # each kernel alone at its main path's shapes, in this call, against
    # that path's wall clock
    ic_df = df_from_f64(ic_dev)
    main_kernel_ms = {
        "float64": min(cuda_ms(lambda: fused_rk4.fused_rk4(
            f64, ic_dev, dts_main, 100)) for _ in range(2)),
        "twofloat": min(cuda_ms(lambda: fused_df_rk4.fused_df_rk4(
            fdf, *ic_df, dts_main, 100)) for _ in range(2))}
    for precision, ms in main_kernel_ms.items():
        print(f"[5] {precision} kernel at the main path's shapes (B=4096, "
              f"10000 steps, a record every 100): {ms:.3f} ms; the main "
              f"path took {main_s[precision] * 1e3:.3f} ms, the kernel "
              f"{ms / (main_s[precision] * 1e3):.4f} of it; {card}",
              flush=True)

    # each kernel for every G, in turns (G ascending, then descending)
    per_g = {}
    for Bg in (4096, 16384):
        yg = yb[:Bg].contiguous()
        yg32, ygdf = yg.float(), df_from_f64(yg)
        for name, run_g, work in (
                ("f64", lambda d, G: at_groups(fused_rk4.K1, f64, yg, d, 0, G),
                 rk4_work(Bg, n, coo.coords, steps, 8)),
                ("f32", lambda d, G: at_groups(fused_rk4.K1, f32, yg32, d, 0,
                                               G),
                 rk4_work(Bg, n, coo.coords, steps, 4)),
                ("df", lambda d, G: at_groups(fused_df_rk4.DF, fdf, ygdf, d,
                                              0, G),
                 df_rk4_work(Bg, n, coo.coords, steps))):
            for G in GROUPS_TRIED:
                run_g(dts_b[:10], G)
            runs_g = {G: [] for G in GROUPS_TRIED}
            for G in GROUPS_TRIED + GROUPS_TRIED[::-1]:
                runs_g[G].append(cuda_ms(lambda: run_g(dts_b, G)))
            b_ms, _ = bound(*work, PEAK_FLOPS["f64" if name == "f64"
                                              else "f32"])
            for G, rs in runs_g.items():
                per_g[f"{name} B={Bg} G={G}"] = min(rs)
                print(f"[5] per G: {name} B={Bg} {steps} steps G={G}: "
                      f"{min(rs):.3f} ms (runs {rs[0]:.3f}/{rs[1]:.3f}), "
                      f"bound {b_ms:.3f} ms, share {b_ms / min(rs):.4f}; "
                      f"{card}", flush=True)

    # -- 6. the tangent-linear and Lyapunov paths ----------------------------
    tangent, flv_launches = tangent_phase(f, Df, qgt, card, dev)

    # -- 7. the rank-5 models, QgsModel and TrajectoriesStatistics ----------
    rank5 = rank5_phase(card, dev)

    # -- 8. the diagnostics, and a profiler trace of the main path ---------
    diagnostics = diagnostics_phase(f, ic, card, dev)

    # -- 9. the parallel layer and the drivers -------------------------------
    parallel, parallel_launches = parallel_phase(f, Df, ic, main_traj["float64"],
                                                 card, dev)

    # -- 10. the reference-compatibility surface -----------------------------
    compat, compat_launches = compat_phase(f, qgt, card, dev)

    # -- 11. the examples ----------------------------------------------------
    examples_out, examples_launches = examples_phase(card)

    # -- 12. models past one block's shared memory -------------------------
    large, large_launches = large_models_phase(card, dev)

    # -- 13. the long-horizon climate gate ----------------------------------
    fidelity, fidelity_launches = fidelity_phase(card, dev)

    leaked = sorted(m for m in ("jax", "qgs_tpu") if m in sys.modules)
    if leaked:
        fail(f"{' and '.join(leaked)} got imported during the smoke run")

    kernels = [{
        "name": "rk4_fused",
        "route": "cuda",
        "source": "qgs_tpu_torch/csrc/rk4_fused.cu",
        "replaces": "qgs_tpu/ops/pallas_kernels.py:210",
        "launches": (launches["rk4_fused"] + parallel_launches["rk4_fused"]
                     + compat_launches["rk4_fused"]
                     + examples_launches["rk4_fused"]
                     + large_launches["rk4_fused"]
                     + fidelity_launches["rk4_fused"]),
        "main_path_launches": launches["rk4_fused"],
        "parallel_launches": parallel_launches["rk4_fused"],
        "compat_launches": compat_launches["rk4_fused"],
        "examples_launches": examples_launches["rk4_fused"],
        "large_models_launches": large_launches["rk4_fused"],
        "fidelity_launches": fidelity_launches["rk4_fused"],
        "ndim104": large["k1_ndim104"],
        "flv_launches": flv_launches["float64"]["rk4_fused"],
        "max_abs_err": max(errs64),
        "ms": times["f64"][0],
        "plain_ms": times["f64"][1],
        "bound_ms": bounds["f64"][0],
        "bound_by": bounds["f64"][1],
        "share_of_bound": bounds["f64"][0] / times["f64"][0],
        "library_ms": None,
        "shape": f"B={B} n={n} steps={steps} float64, "
                 f"G={fused_rk4.K1.groups}",
        "main_path_max_abs_err_vs_f64": err_main["float64"][1],
        "main_path_s": main_s["float64"],
        "main_path_kernel_ms": main_kernel_ms["float64"],
        "f32_max_abs_err": max(errs32),
        "f32_ms": times["f32"][0],
        "f32_plain_ms": times["f32"][1],
        "f32_bound_ms": bounds["f32"][0],
        "f32_share_of_bound": bounds["f32"][0] / times["f32"][0],
        "ms_per_groups": {k: v for k, v in per_g.items()
                          if not k.startswith("df ")},
        "card": card,
    }, {
        "name": "rk4_df_fused",
        "route": "cuda",
        "source": "qgs_tpu_torch/csrc/rk4_df_fused.cu",
        "replaces": "qgs_tpu/ops/pallas_kernels.py:107",
        "launches": (launches["rk4_df_fused"]
                     + parallel_launches["rk4_df_fused"]
                     + compat_launches["rk4_df_fused"]
                     + examples_launches["rk4_df_fused"]
                     + large_launches["rk4_df_fused"]
                     + fidelity_launches["rk4_df_fused"]),
        "main_path_launches": launches["rk4_df_fused"],
        "parallel_launches": parallel_launches["rk4_df_fused"],
        "compat_launches": compat_launches["rk4_df_fused"],
        "examples_launches": examples_launches["rk4_df_fused"],
        "large_models_launches": large_launches["rk4_df_fused"],
        "fidelity_launches": fidelity_launches["rk4_df_fused"],
        "flv_launches": flv_launches["twofloat"]["rk4_df_fused"],
        "max_abs_err": err_df,
        "ms": times["df"][0],
        "plain_ms": times["df"][1],
        "bound_ms": bounds["df"][0],
        "bound_by": bounds["df"][1],
        "share_of_bound": bounds["df"][0] / times["df"][0],
        "library_ms": None,
        "shape": f"B={B} n={n} steps={steps} double-float, "
                 f"G={fused_df_rk4.DF.groups}",
        "main_path_max_abs_err_vs_f64": err_main["twofloat"][1],
        "main_path_members_0_7_max_abs_err_vs_f64": err_main["twofloat"][0],
        "main_path_s": main_s["twofloat"],
        "main_path_kernel_ms": main_kernel_ms["twofloat"],
        "ms_per_groups": {k: v for k, v in per_g.items()
                          if k.startswith("df ")},
        "card": card,
    }]
    for name, sfx, main_shape in (
            ("rk4_streamed", "", "ndim228_float64_B1024_x200"),
            ("rk4_df_streamed", "df_", "ndim104_twofloat_B1024_x200")):
        main_row = large["times"][main_shape]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"qgs_tpu_torch/csrc/{name}.cu",
            "replaces": "qgs_tpu/ops/pallas_kernels.py:" + (
                "107" if sfx else "210"),
            "launches": large_launches[name],
            "large_models_launches": large_launches[name],
            "max_abs_err": large["streamed_max_abs_err"][name],
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "share_of_bound": main_row["share_of_bound"],
            "library_ms": None,
            "shape": main_shape,
            "times": {k: v for k, v in large["times"].items()
                      if v["kernel"] == name},
            "bit_equal_to_resident": {
                k: v for k, v in large["streamed_bit_equal_to_resident"].items()
                if (k.endswith("twofloat") == bool(sfx))},
            "card": card,
        })
    kernels[2]["f32_max_abs_err"] = \
        large["streamed_max_abs_err"]["rk4_streamed_f32"]
    one_buffer = large["k1_1buf"]
    kernels.append({
        "name": "rk4_streamed_1buf",
        "route": "cuda",
        "source": "qgs_tpu_torch/csrc/rk4_streamed.cu",
        "replaces": "qgs_tpu/ops/pallas_kernels.py:210",
        # phase 12's integrate at ndim 600 (launches_streamed counts it too)
        "launches": large_launches["rk4_streamed_1buf"],
        "large_models_launches": large_launches["rk4_streamed_1buf"],
        "max_abs_err": one_buffer["max_abs_err"],
        "ms": one_buffer["ms"],
        "plain_ms": one_buffer["plain_ms"],
        "bound_ms": one_buffer["bound_ms"],
        "bound_by": one_buffer["bound_by"],
        "share_of_bound": one_buffer["share_of_bound"],
        "library_ms": None,
        "shape": one_buffer["shape"],
        "card": card,
    })
    # K5's two layouts, each its own kernel: the main path's launches
    # (phase 7's two float64 integrations and the examples'; the timing
    # launches are not counted) split by the paired counter, each layout's
    # own time, bound and error at the T4 cell's call
    k5_t4 = rank5["t4"]["k5_B4096_500_steps"]
    paired = {"rank5": rank5["rank5_launches"]["rk4_paired"],
              "examples": examples_launches["rk4_paired"]}
    k5_launches = {"rank5": rank5["rank5_launches"]["rk4_quartic"],
                   "examples": examples_launches["rk4_quartic"]}
    for kern, kname, main_launches in (
            ("resident", "rk4_quartic",
             {k: v - paired[k] for k, v in k5_launches.items()}),
            ("paired", "rk4_paired", paired)):
        t4 = k5_t4["by_layout"][kern]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "qgs_tpu_torch/csrc/rk4_fused.cu",
            "replaces": None,
            "launches": sum(main_launches.values()),
            "rank5_launches": main_launches["rank5"],
            "examples_launches": main_launches["examples"],
            "max_abs_err": max(rank5[m]["k5_B4096_500_steps"]["by_layout"][
                kern]["max_abs_err"] for m in ("t4", "dynT")),
            "ms": t4["ms"],
            "plain_ms": k5_t4["plain_ms"],
            "bound_ms": k5_t4["bound_ms"],
            "bound_by": k5_t4["bound_by"],
            "share_of_bound": t4["share_of_bound"],
            "library_ms": None,
            "shape": (f"T4 B=4096 n=38 steps=500 float64, "
                      f"G={k5_t4['groups']}"),
            "ms_per_groups": {k: v for k, v in k5_t4["ms_per_groups"].items()
                              if k.startswith(f"{kern} ")},
            "f32": rank5["t4"]["k5_f32_B4096_500_steps"]["by_layout"][kern],
            "dynT": rank5["dynT"]["k5_B4096_500_steps"]["by_layout"][kern],
            "dynT_f32": rank5["dynT"]["k5_f32_B4096_500_steps"][
                "by_layout"][kern],
            "card": card,
        })
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"diagnostics": diagnostics}), flush=True)
    print(json.dumps({"rank5": rank5}), flush=True)
    print(json.dumps({"tangent": tangent}), flush=True)
    print(json.dumps({"compat": compat}), flush=True)
    print(json.dumps({"examples": examples_out}), flush=True)
    print(json.dumps({"large_models": large}), flush=True)
    print(json.dumps({"fidelity": fidelity}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
