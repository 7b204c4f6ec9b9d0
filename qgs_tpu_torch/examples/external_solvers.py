"""Driving the model tendencies with an external ODE suite (counterpart of
``examples/external_solvers.py``).

The framework's central API contract is the reference's: a plain callable
``f(t, x)`` and its Jacobian ``Df(t, x)``.  Given a NumPy state they return
a NumPy array, whatever device the model lives on: the state goes to the
device, the tendency is evaluated there and the result comes back to the
host.  So any integrator that takes an ``f(t, y)`` right-hand side uses
them directly; here scipy's ``solve_ivp`` (adaptive RK45 and the
stiff-capable LSODA), cross-checked against the port's fixed-step RK4.  On
the card every evaluation is a round trip between the host and the card;
the example prints the time it took.
"""

import numpy as np
from scipy.integrate import solve_ivp

from qgs_tpu_torch.examples import F64, cli, seconds
from qgs_tpu_torch.integrators.rk import integrate_runge_kutta
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.params.params import QgParams

TIMES = {False: dict(transient=2000., span=100.),
         True: dict(transient=200., span=10.)}
# scipy's adaptive steps may be chosen differently when f differs by
# rounding; the three solvers agree far better than the trajectory scale
# (the JAX example's bound)
IVP = dict(rtol=1e-8, atol=1e-10)
BOUND = 1e-4
TOLERANCES = {"rk45": IVP, "lsoda": IVP, "native": F64}


def params(QgParams=QgParams):
    """The Reinhold-Pierrehumbert atmosphere (20 variables) with a higher
    orography and a deeper thermal forcing."""
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.3})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.4, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    return pars


def main(device="cuda", short=False, plot=True, outdir="."):
    # nothing is drawn: plot and outdir are accepted for the common call
    times = TIMES[short]
    pars = params()
    f, Df = create_tendencies(pars, device=device)

    # spin onto the attractor with the port's integrator (on the card, one
    # launch of the fused RK4 kernel)
    rng = np.random.default_rng(21)
    ic = rng.random(pars.ndim) * 0.01
    _, y0 = integrate_runge_kutta(f.batched, 0., times["transient"], 0.1, ic,
                                  write_steps=0)
    y0 = y0.cpu().numpy()

    span = times["span"]
    t_eval = np.arange(0., span + 0.001, 0.1)
    # f and Df take and return NumPy arrays: scipy calls them as they are
    sol_rk45, s_rk45 = seconds(lambda: solve_ivp(
        f, (0., span), y0, method="RK45", t_eval=t_eval, rtol=1e-10,
        atol=1e-12), device)
    sol_lsoda, s_lsoda = seconds(lambda: solve_ivp(
        f, (0., span), y0, method="LSODA", jac=Df, t_eval=t_eval,
        rtol=1e-10, atol=1e-12), device)
    _, y_native = integrate_runge_kutta(f.batched, 0., span, 0.1, y0,
                                        write_steps=1)
    y_native = y_native.cpu().numpy()

    print(f"scipy RK45 : {sol_rk45.nfev} RHS evals, status={sol_rk45.status}"
          f", {s_rk45:.3f} s on {device} "
          f"({s_rk45 / sol_rk45.nfev * 1e6:.1f} us an evaluation)")
    print(f"scipy LSODA: {sol_lsoda.nfev} RHS evals, {sol_lsoda.njev} "
          f"Jacobian evals, status={sol_lsoda.status}, {s_lsoda:.3f} s")
    errs = {}
    for name, sol in (("RK45", sol_rk45), ("LSODA", sol_lsoda)):
        errs[name] = float(np.abs(sol.y - y_native).max()
                           / np.abs(y_native).max())
        print(f"{name} vs native RK4 over {span:g} time units: max rel diff "
              f"{errs[name]:.2e}")

    if not (sol_rk45.status == sol_lsoda.status == 0):
        raise RuntimeError("solve_ivp did not reach the end of the span")
    if errs["RK45"] >= BOUND:
        raise RuntimeError(f"RK45 and the native RK4 differ by "
                           f"{errs['RK45']:.2e} >= {BOUND} of the scale")
    print("external-solver interop OK")
    return dict(rk45=sol_rk45.y, lsoda=sol_lsoda.y, native=y_native,
                err_rk45=errs["RK45"], err_lsoda=errs["LSODA"],
                nfev_rk45=sol_rk45.nfev, seconds_rk45=s_rk45,
                seconds_lsoda=s_lsoda)


if __name__ == "__main__":
    cli(main)
