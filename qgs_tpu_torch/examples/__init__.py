"""
Examples
========

The port's counterparts of the JAX package's ``examples/*.py``: runnable
modules that drive the port the way a user's script does, on the CUDA card
unless told otherwise.

Each module, what it shows, and the kernels it launches on the card:

* ``rp_atmosphere``: the Reinhold-Pierrehumbert atmosphere (ndim 20), an
  attractor run, variable series, the geopotential height.  K1.
* ``maooam_coupled``: the coupled ocean-atmosphere MAOOAM (ndim 36), a
  2 x 2 diagnostics dashboard.  K1.
* ``ground_coupled``: an atmosphere over a ground with heat exchange and
  orography, the ground temperature anomaly.  K1.
* ``precision_tiers``: float64, float32 and twofloat integrations side by
  side, their errors and rates; the Lyapunov spectrum in float64 against
  twofloat.  K1 (float64 and float32), K2.
* ``external_solvers``: ``f(t, x)`` / ``Df(t, x)`` on NumPy states driven
  by scipy's RK45 and LSODA.  K1 (the RK4 they are checked against).
* ``lyapunov_exponents``: the Benettin backward spectrum and Ginelli CLVs
  of RP.  K1 (the transient).
* ``clv_walkthrough``: CLVs in depth: spectrum, local exponents, a CLV's
  streamfunction pattern, angles, the covariance check through one
  tangent-linear step.  K1 (the transient).
* ``ensemble_statistics``: ``TrajectoriesStatistics`` over an ensemble,
  the ensemble mesh.  K1.
* ``distributed_ensembles``: an ('ensemble', 'model') mesh, the
  row-sharded tendency, a two-process run over gloo.  K1, one launch a
  shard.
* ``dynamic_temperature``: dynamic 0-th order temperatures (rank 5, ndim
  38), the direct tangent against ``Df @ dm``.  K5.
* ``t4_radiation``: the quartic T^4 radiation scheme (rank 5), its
  two-level layout, twofloat against float64.  K5 (float64; twofloat runs
  plain ops).
* ``diagnostics_tour``: twelve field diagnostics and an eddy heat flux
  profile of one RP trajectory.  K1.
* ``kernel_selection``: every ``mode=`` name runs one gather path; which
  precision launches which kernel.  K1 (float64 and float32), K2.
* ``custom_basis``: a SymPy basis with a weighted inner product, the
  tendency on NumPy states.  Neither.
* ``symbolic_export``: python, Fortran and AUTO-07p code with ``k_d``
  left free.  Neither (host, SymPy).
* ``auto_continuation``: the AUTO-07p files, and the generated python
  against ``f`` on the device.  Neither.

K1 is the fused RK4 kernel (``csrc/rk4_fused.cu``), K2 its double-float
twin (``csrc/rk4_df_fused.cu``) and K5 its rank-5 counterpart (K1's
resident kernel over a four-index entry, float64 and float32); other paths
of the rank-5 models run on plain torch ops.

Each module has ``main(device="cuda", short=False, plot=True, outdir=".")``:
it prints what its JAX counterpart prints and returns a dict of the numbers
it prints.  ``short=True`` cuts only lengths (transients, windows, record
counts), never a configuration's widths.  ``plot=True`` imports matplotlib
(an ``ImportError`` without it) and writes its figures into ``outdir``.
Run one as::

    python -m qgs_tpu_torch.examples.rp_atmosphere [--device cpu] [--short]
        [--no-plot] [--outdir DIR]

A module's ``params(QgParams=QgParams)`` builds its configuration on the
``QgParams`` class it is given (the port's, by default).  Each module's
``TOLERANCES`` gives, for each returned number it holds, the
tolerance of a run on one device against a run on another (the card
against the CPU): the summation order is all that differs.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

# the module names, in the catalog's order
NAMES = ("rp_atmosphere", "maooam_coupled", "ground_coupled",
         "precision_tiers", "external_solvers", "lyapunov_exponents",
         "clv_walkthrough", "ensemble_statistics", "distributed_ensembles",
         "dynamic_temperature", "t4_radiation", "diagnostics_tour",
         "kernel_selection", "custom_basis", "symbolic_export",
         "auto_continuation")

# float64 trajectories, one summation order against another
# (tests/test_trajectory.py:57)
F64 = dict(rtol=1e-9, atol=1e-11)
# float64 Lyapunov exponents (tests/test_lyapunov.py)
LYAP = dict(rtol=1e-9, atol=1e-9)
# float32 integrations: float32 rounding in two summation orders
F32 = dict(rtol=1e-4, atol=1e-6)
# fields of a float64 trajectory: the trajectory's tolerance, the atol a
# share of max|field| (a field is linear in the trajectory and crosses 0)
FIELD = dict(rtol=1e-9, atol=1e-9, scaled=True)


def compare(got, ref, tolerances):
    """Hold the numbers ``got`` (an example's returned dict) against
    ``ref`` key by key at ``tolerances`` (a module's ``TOLERANCES``);
    returns ``{key: (max_abs_err, ok)}``."""
    out = {}
    for key, tol in tolerances.items():
        g = np.asarray(got[key], np.float64)
        r = np.asarray(ref[key], np.float64)
        if g.shape != r.shape:
            out[key] = (float("inf"), False)
            continue
        scale = np.nanmax(np.abs(r), initial=0.) if tol.get("scaled") else 1.
        ok = bool(np.allclose(g, r, rtol=tol["rtol"], atol=tol["atol"] * scale,
                              equal_nan=True))
        out[key] = (float(np.nanmax(np.abs(g - r), initial=0.)), ok)
    return out


def pyplot():
    """matplotlib's pyplot on the Agg backend; raises ``ImportError``
    where matplotlib is not installed."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def savefig(plt, outdir, name, dpi=100):
    """Save the current figure as ``outdir/name`` and close every figure."""
    os.makedirs(outdir, exist_ok=True)
    plt.savefig(os.path.join(outdir, name), dpi=dpi)
    plt.close("all")


def seconds(fn, device):
    """``(fn(), seconds)`` by the host clock, the card synchronised before
    and after."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cli(main, **extra):
    """Run an example's ``main`` from the command line; ``extra`` names
    further on/off arguments of ``main`` with their defaults."""
    parser = argparse.ArgumentParser(
        description=sys.modules[main.__module__].__doc__)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--short", action="store_true",
                        help="shorter transients, windows and records")
    parser.add_argument("--no-plot", action="store_true",
                        help="compute everything, draw nothing")
    parser.add_argument("--outdir", default=".")
    for name, default in extra.items():
        parser.add_argument(f"--{name.replace('_', '-')}",
                            action=argparse.BooleanOptionalAction,
                            default=default)
    args = vars(parser.parse_args())
    args["plot"] = not args.pop("no_plot")
    return main(**args)
