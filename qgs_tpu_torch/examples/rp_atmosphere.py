"""Reinhold-Pierrehumbert atmosphere: attractor run, scalar variable series
and a streamfunction snapshot (counterpart of ``examples/rp_atmosphere.py``).
"""

import numpy as np

from qgs_tpu_torch.diagnostics.streamfunctions import (
    MiddleAtmosphericStreamfunctionDiagnostic)
from qgs_tpu_torch.diagnostics.variables import VariablesDiagnostic
from qgs_tpu_torch.examples import F64, FIELD, cli, pyplot, savefig
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.params.params import QgParams

# time units: the spin-up onto the attractor, and the recorded run
TIMES = {False: dict(transient=2.e4, span=1000.),
         True: dict(transient=100., span=50.)}
TOLERANCES = {"time": F64, "traj": F64, "variables": F64,
              "psi_last": FIELD}


def params(QgParams=QgParams):
    """The Reinhold & Pierrehumbert (1982) setup: a two-layer
    quasi-geostrophic channel atmosphere at 50N, truncated at wavenumber 2
    in both directions (10 spatial modes -> 20 variables), with a
    mountain/valley orography of height 0.2 and Newtonian cooling toward an
    equator-to-pole radiative-equilibrium gradient of 0.2."""
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.2, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    return pars


def main(device="cuda", short=False, plot=True, outdir="."):
    plt = pyplot() if plot else None
    times = TIMES[short]
    pars = params()

    # The Galerkin tendency tensor is assembled once on the host and laid
    # out on the device; f and Df are the tendency and Jacobian callables
    # (the framework's central API contract).
    f, Df = create_tendencies(pars, device=device)
    integrator = RungeKuttaIntegrator()
    integrator.set_func(f)

    # Spin up from a random state so transients decay onto the chaotic
    # attractor, then record every 5 steps.  On the card each call is one
    # launch of the fused RK4 kernel, with the state kept on chip.
    rng = np.random.default_rng(21217)
    integrator.integrate(0., times["transient"], 0.1,
                         ic=rng.random(pars.ndim) * 0.1, write_steps=0)
    _, y0 = integrator.get_trajectories()
    integrator.integrate(0., times["span"], 0.1, ic=y0, write_steps=5)
    t, traj = integrator.get_trajectories()

    # The scalar-variable diagnostic gives raw spectral coefficients;
    # psi_a_1 (the zonal-flow mode) switches between the flow regimes.
    vd = VariablesDiagnostic([0, 1, 2], pars, dimensional=False,
                             device=device)
    variables = vd(t, traj)

    # The 500 hPa geopotential height on a lat-lon grid: one matrix
    # product of the spectral coefficients with the gridded basis.
    psi = MiddleAtmosphericStreamfunctionDiagnostic(pars, geopotential=True,
                                                    device=device)
    field = psi(t, traj)
    print(f"{len(t)} records over {t[-1] - t[0]:g} time units; psi_a_1 in "
          f"[{float(variables[0].min()):.4f}, "
          f"{float(variables[0].max()):.4f}]; geopotential height of the "
          f"last record in [{float(field[-1].min()):.2f}, "
          f"{float(field[-1].max()):.2f}] m")

    if plot:
        vd.plot()
        savefig(plt, outdir, "rp_variables.png")
        psi.plot(time_index=-1)
        savefig(plt, outdir, "rp_psi.png")
        print("wrote rp_variables.png, rp_psi.png")
    return dict(time=np.asarray(t), traj=traj.cpu().numpy(),
                variables=variables.cpu().numpy(),
                psi_last=field[-1].cpu().numpy())


if __name__ == "__main__":
    cli(main)
