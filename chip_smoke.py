#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port on one NVIDIA GPU
====================================================

Drives the port's main path (``qgs_tpu_torch``) once on the card: the MAOOAM
configuration (ndim 36) -> ``create_tendencies(device="cuda")`` ->
``RungeKuttaIntegrator.integrate`` of a 4096-member ensemble through the
fused RK4 kernel -> ``get_trajectories``.  Phases:

1. device: a CUDA card is required; prints the card's name and power limit;
2. build: compiles ``qgs_tpu_torch/csrc/rk4_fused.cu`` with nvcc (sm_90a);
3. the kernel against its plain PyTorch version on the card, float64 and
   float32, and the integrator's kernel route against its plain route;
4. the main path, with the kernel's launch count reset just before it;
5. times of the kernel and of its plain version at B = 16384, 1000 steps.

Every failed phase exits nonzero before the last line, which is one JSON
object ``{"ok": true, "device": {...}}``.  Run from the repository root:

    python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# the smoke run never needs the JAX reference: keep its package's import of
# jax off even where jax happens to be installed
os.environ.setdefault("QGS_TPU_X64", "0")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TOL64 = dict(rtol=1e-9, atol=1e-11)    # float64: only the summation order
                                       # and FMA contraction differ
TOL32 = dict(rtol=1e-4, atol=1e-6)     # float32 kernel vs float64 plain


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


def cuda_ms(fn):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


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


def main():
    # -- 1. device ---------------------------------------------------------
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    try:
        from qgs_tpu_torch.host import QgParams
        from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
        from qgs_tpu_torch.integrators.rk import (integrate_runge_kutta,
                                                  time_grid)
        from qgs_tpu_torch.models.tendencies import create_tendencies
        from qgs_tpu_torch.ops import _build, fused_rk4
        from qgs_tpu_torch.ops.contraction import from_numpy
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
    print(f"[2] build: rk4_fused.cu in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
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
    y0 = torch.as_tensor(np.random.default_rng(1).random((1000, n)) * 0.01,
                         device=dev)
    yk, rk = fused_rk4.fused_rk4(f64, y0, dts, 7)
    yr, rr = fused_rk4.fused_rk4_reference(f64, y0, dts, 7)
    check_close("f64 B=1000 301 steps final", yk, yr, TOL64)
    check_close("f64 B=1000 records every 7", rk, rr, TOL64)

    yk32, _ = fused_rk4.fused_rk4(f32, y0.float(), dts[:100].contiguous(), 0)
    yr64, _ = fused_rk4.fused_rk4_reference(f64, y0, dts[:100], 0)
    err32 = check_close("f32 kernel vs f64 plain, 100 steps", yk32, yr64,
                        TOL32)

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

    # the main path's shapes: B = 4096, the 10000-step grid, a record every 100
    ic = np.random.default_rng(0).random((4096, n)) * 0.01
    ic_dev = torch.as_tensor(ic, device=dev)
    dts_main = torch.as_tensor(np.diff(time_grid(0., 1000., 0.1)), device=dev)
    yk, rk = fused_rk4.fused_rk4(f64, ic_dev, dts_main, 100)
    yr, rr = fused_rk4.fused_rk4_reference(f64, ic_dev, dts_main, 100)
    check_close("f64 B=4096 10000 steps final", yk, yr, TOL64)
    err64 = check_close("f64 B=4096 records every 100", rk, rr, TOL64)

    # -- 4. the main path: f, Df from create_tendencies(device="cuda") above
    integrator = RungeKuttaIntegrator()
    integrator.set_func(f)
    torch.cuda.synchronize()
    fused_rk4.launches = 0
    t0 = time.perf_counter()
    integrator.integrate(0., 1000., 0.1, ic=ic, write_steps=100)
    t, traj = integrator.get_trajectories()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    main_launches = fused_rk4.launches
    print(f"[4] main path: integrate(0, 1000, 0.1, B=4096, write_steps=100) "
          f"in {main_s:.3f} s, fused_rk4 launches {main_launches}",
          flush=True)
    if main_launches < 1:
        fail("the main path did not launch the fused RK4 kernel")
    if tuple(traj.shape) != (4096, n, 101) or traj.device.type != "cuda":
        fail(f"trajectory shape {tuple(traj.shape)} on {traj.device}, "
             f"expected (4096, {n}, 101) on cuda")
    if not torch.isfinite(traj).all():
        fail("non-finite values in the trajectory")
    if len(t) != 101 or t[0] != 0. or t[-1] != 1000.:
        fail(f"record times {t[:3]}...{t[-3:]}")
    tp, trp = integrate_runge_kutta(lambda tt, x: f.batched(tt, x), 0.,
                                    1000., 0.1, ic_dev[:8], write_steps=100)
    if not np.array_equal(t, tp):
        fail("main path record times differ from the plain path")
    check_close("main path members 0-7 vs plain f64 path", traj[:8], trp,
                TOL64)

    # -- 5. times ----------------------------------------------------------
    B, steps = 16384, 1000
    yb = torch.as_tensor(np.random.default_rng(2).random((B, n)) * 0.01,
                         device=dev)
    dts_b = torch.full((steps,), 0.1, dtype=torch.float64, device=dev)
    times = {}
    for name, fm, y in (("f64", f64, yb), ("f32", f32, yb.float())):
        fused_rk4.fused_rk4(fm, y, dts_b[:10], 0)                # warm-up
        fused_rk4.fused_rk4_reference(fm, y, dts_b[:10], 0)
        plain1 = cuda_ms(lambda: fused_rk4.fused_rk4_reference(fm, y, dts_b))
        kern1 = cuda_ms(lambda: fused_rk4.fused_rk4(fm, y, dts_b))
        kern2 = cuda_ms(lambda: fused_rk4.fused_rk4(fm, y, dts_b))
        plain2 = cuda_ms(lambda: fused_rk4.fused_rk4_reference(fm, y, dts_b))
        kern, plain = min(kern1, kern2), min(plain1, plain2)
        times[name] = (kern, plain)
        print(f"[5] {name} B={B} {steps} steps: kernel {kern:.3f} ms "
              f"({B * steps / kern * 1e3:.4g} traj-steps/s), plain "
              f"{plain:.3f} ms ({B * steps / plain * 1e3:.4g} traj-steps/s); "
              f"runs kernel {kern1:.3f}/{kern2:.3f}, plain "
              f"{plain1:.3f}/{plain2:.3f} ms; {card}", flush=True)

    jax_mod = sys.modules.get("jax")
    if jax_mod is not None:
        fail("jax was imported during the smoke run")

    kernels = [{
        "name": "rk4_fused",
        "route": "cuda",
        "source": "qgs_tpu_torch/csrc/rk4_fused.cu",
        "replaces": "qgs_tpu/ops/pallas_kernels.py:210",
        "launches": main_launches,
        "max_abs_err": err64,
        "ms": times["f64"][0],
        "plain_ms": times["f64"][1],
        "shape": f"B={B} n={n} steps={steps} float64",
        "f32_max_abs_err": err32,
        "f32_ms": times["f32"][0],
        "f32_plain_ms": times["f32"][1],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
