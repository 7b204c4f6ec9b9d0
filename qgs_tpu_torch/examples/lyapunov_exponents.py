"""Lyapunov spectrum and covariant vectors of the RP atmosphere
(counterpart of ``examples/lyapunov_exponents.py``)."""

import numpy as np

from qgs_tpu_torch.examples import F64, LYAP, cli
from qgs_tpu_torch.examples.rp_atmosphere import params
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.toolbox.lyapunov import (CovariantLyapunovsEstimator,
                                            LyapunovsEstimator)

# time units: the spin-up; the Benettin run (tw, t); the Ginelli run (ta,
# tb, tc)
TIMES = {False: dict(transient=2.e4, tw=1000., t=5000., ta=500., tb=1500.,
                     tc=2000.),
         True: dict(transient=100., tw=10., t=30., ta=5., tb=15., tc=20.)}
TOLERANCES = {"ic": F64, "spectrum": LYAP, "clv_spectrum": LYAP}


def main(device="cuda", short=False, plot=True, outdir="."):
    # nothing is drawn: plot and outdir are accepted for the common call
    times = TIMES[short]
    # the RP atmosphere again: small enough (20 variables) that the full
    # Lyapunov spectrum and all covariant vectors are cheap
    pars = params()
    f, Df = create_tendencies(pars, device=device)

    integrator = RungeKuttaIntegrator()
    integrator.set_func(f)
    rng = np.random.default_rng(1)
    integrator.integrate(0., times["transient"], 0.1,
                         ic=rng.random(pars.ndim) * 0.1, write_steps=0)
    _, ic = integrator.get_trajectories()

    # Backward Lyapunov vectors and exponents by the Benettin QR
    # algorithm: the fundamental matrix is propagated over sub-intervals of
    # step mdt and re-orthonormalized by a batched QR; the exponents are
    # the time averages of log|diag R|.
    est = LyapunovsEstimator()
    est.set_func(f, Df)
    est.compute_lyapunovs(0., times["tw"], times["t"], 0.1, 0.1, ic,
                          write_steps=10)
    t, traj, exps, vecs = est.get_lyapunovs()
    spectrum = np.sort(exps.mean(axis=-1))[::-1]
    ky = int((np.cumsum(spectrum) > 0).sum())
    print("Backward Lyapunov spectrum (per time unit):")
    print(np.array2string(spectrum, precision=4))
    print("Kaplan-Yorke dimension estimate:", ky)

    # Covariant Lyapunov vectors by the Ginelli et al. (2007) method
    # (method=0: a forward Benettin pass stores R, a backward substitution
    # converges the coefficients); method=1 intersects BLV and FLV
    # subspaces instead.
    cest = CovariantLyapunovsEstimator()
    cest.set_func(f, Df)
    cest.compute_clvs(0., times["ta"], times["tb"], times["tc"], 0.1, 0.1,
                      ic, write_steps=10)
    _, _, cexps, _ = cest.get_clvs()
    clv_spectrum = cexps.mean(axis=-1)
    print("CLV mean exponents:", np.array2string(clv_spectrum, precision=4))
    return dict(ic=ic.cpu().numpy(), spectrum=spectrum,
                kaplan_yorke=ky, clv_spectrum=clv_spectrum)


if __name__ == "__main__":
    cli(main)
