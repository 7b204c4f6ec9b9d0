"""The three precision tiers side by side on MAOOAM: float64, float32 and
twofloat (double-float pairs of float32 with error-free transformations),
their errors against float64 and their rates, and the Lyapunov spectrum in
float64 against twofloat (counterpart of ``examples/precision_tiers.py``).
"""

import numpy as np
import torch

from qgs_tpu_torch.examples import F32, F64, LYAP, cli, seconds
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops.contraction import make_tendency_fns
from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.toolbox.lyapunov import LyapunovsEstimator

B = 1024                  # members
# RK4 steps of dt 0.1; time units of the Lyapunov run: the transient
# window tw and the end t
TIMES = {False: dict(steps=200, tw=10., t=40.),
         True: dict(steps=20, tw=2., t=8.)}
# twofloat Benettin exponents against float64 (tests/test_lyapunov.py)
TWOFLOAT_LYAP = dict(rtol=5e-8, atol=5e-8)
TOLERANCES = {"y64": F64, "y32": F32, "ydf": F64, "lyap64": LYAP,
              "lyapdf": TWOFLOAT_LYAP}


def params(QgParams=QgParams):
    """MAOOAM's 2x2-block atmosphere and 2x4-block ocean (ndim 36) at the
    default parameters."""
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    return pars


def _integrate(f, precision, x, steps, device):
    """``steps`` RK4 steps of the whole ensemble through the integrator,
    timed after a one-step warm-up: ``(final state as float64 NumPy,
    traj-steps/s)``."""
    integrator = RungeKuttaIntegrator(precision=precision)
    integrator.set_func(f)

    def run(n):
        integrator.integrate(0., n * 0.1, 0.1, ic=x, write_steps=0)
        return integrator.get_trajectories()[1]

    run(1)
    y, s = seconds(lambda: run(steps), device)
    return y.double().cpu().numpy(), steps * B / s


def main(device="cuda", short=False, plot=True, outdir="."):
    # nothing is drawn: plot and outdir are accepted for the common call
    times = TIMES[short]
    pars = params()
    f, Df, tensor = create_tendencies(pars, return_qgtensor=True,
                                      device=device)
    x = np.random.default_rng(0).random((B, pars.ndim)) * 0.05

    # float64: the card's native double precision, through the fused RK4
    # kernel's double build.
    steps = times["steps"]
    y64, rate64 = _integrate(f, "float64", x, steps, device)
    # float32: the same integrator given a float32 tendency runs the
    # kernel's float build.
    f32, _ = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor,
                               dtype=torch.float32, device=device)
    y32, rate32 = _integrate(f32, "float64", x, steps, device)
    # twofloat: each value an (hi, lo) pair of float32 whose sum carries
    # about 48 bits of mantissa; sums and products by error-free
    # transformations (Knuth two-sum, Dekker product), through the fused
    # double-float RK4 kernel.
    ydf, ratedf = _integrate(f, "twofloat", x, steps, device)
    err32 = float(np.abs(y32 - y64).max())
    errdf = float(np.abs(ydf - y64).max())

    print(f"{'tier':<10} {'traj-steps/s':>15} "
          f"{f'max err vs f64 after {steps} steps':>32}")
    rates = {"float64": rate64, "float32": rate32, "twofloat": ratedf}
    for k, err in (("float64", 0.), ("float32", err32), ("twofloat", errdf)):
        print(f"{k:<10} {rates[k]:>15,.0f} {err:>32.3e}")
    print(f"(rates measured in this run on {device}, B={B})")

    # The same tiers exist for the tangent-linear system and the Lyapunov
    # toolbox: precision='twofloat' propagates the tangent in double-float
    # and converts to float64 for the QR.
    ic = ydf[:1]
    spectra = {}
    for precision in ("float64", "twofloat"):
        est = LyapunovsEstimator(precision=precision)
        est.set_func(f, Df)
        est.compute_lyapunovs(0., times["tw"], times["t"], 0.1, 0.1, ic,
                              write_steps=1)
        spectra[precision] = est.get_lyapunovs()[2].mean(-1)
    m64, mdf = spectra["float64"], spectra["twofloat"]
    print("\nLyapunov spectrum, f64 vs twofloat tier (leading 5):")
    print("  f64     :", np.array2string(m64[:5], precision=6))
    print("  twofloat:", np.array2string(mdf[:5], precision=6))
    print(f"  max |diff| = {np.abs(m64 - mdf).max():.2e}")
    return dict(y64=y64, y32=y32, ydf=ydf, err32=err32, errdf=errdf,
                lyap64=m64, lyapdf=mdf, rates=rates)


if __name__ == "__main__":
    cli(main)
