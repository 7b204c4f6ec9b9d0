"""Atmosphere coupled to a land/ground component with heat exchange and
orography, the MAOSOAM-like configuration (counterpart of
``examples/ground_coupled.py``)."""

import numpy as np

from qgs_tpu_torch.diagnostics.temperatures import (
    GroundTemperatureAnomalyDiagnostic)
from qgs_tpu_torch.examples import F64, FIELD, cli
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.params.params import QgParams

TIMES = {False: dict(transient=1.e4, span=500.),
         True: dict(transient=100., span=50.)}
TOLERANCES = {"time": F64, "traj": F64, "field_range": FIELD}


def params(QgParams=QgParams):
    """Atmosphere over land (the MAOSOAM-like configuration of Li et al.
    2018): the ground adds orography and a motionless temperature anomaly
    field exchanging heat with the atmosphere, with no dynamic equation for
    a ground flow.  ``gtemperature_params=True`` selects the
    ground-temperature container at construction."""
    pars = QgParams(gtemperature_params=True)
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_ground_channel_fourier_modes()       # the atmosphere's basis
    pars.ground_params.set_orography(0.2, 1)
    pars.gotemperature_params.set_params({'gamma': 1.6e7})
    return pars


def main(device="cuda", short=False, plot=True, outdir="."):
    # nothing is drawn: plot and outdir are accepted for the common call
    times = TIMES[short]
    pars = params()
    print(f"ndim = {pars.ndim}  (psi_a x{pars.nmod[0]}, theta_a "
          f"x{pars.nmod[0]}, deltaT_g x{pars.nmod[1]})")

    # The ground shares the atmospheric channel basis, so the only new
    # block in the tendency tensor is the heat-exchange coupling; the
    # tensor is rank 3 and runs through the fused RK4 kernel on the card.
    f, Df = create_tendencies(pars, device=device)
    integrator = RungeKuttaIntegrator()
    integrator.set_func(f)
    rng = np.random.default_rng(0)
    integrator.integrate(0., times["transient"], 0.1,
                         ic=rng.random(pars.ndim) * 0.05, write_steps=0)
    _, y0 = integrator.get_trajectories()
    integrator.integrate(0., times["span"], 0.1, ic=y0, write_steps=10)
    t, traj = integrator.get_trajectories()

    # The ground temperature anomaly on the grid, in Kelvin.
    field = GroundTemperatureAnomalyDiagnostic(pars, device=device)(t, traj)
    lo, hi = float(field.min()), float(field.max())
    print("ground temperature anomaly range (K):", lo, "to", hi)
    return dict(time=np.asarray(t), traj=traj.cpu().numpy(),
                field_range=np.array([lo, hi]))


if __name__ == "__main__":
    cli(main)
