#!/usr/bin/env python
"""
Reinhold & Pierrehumbert (1982) model run
=========================================

The port's counterpart of the repository's ``qgs_rp.py``: the 2-layer
channel QG atmosphere truncated at wavenumber 2 with simple orography (a
mountain and a valley), on the card.  The transient spin-up and the
attractor trajectory are each one launch of the fused RK4 kernel::

    python -m qgs_tpu_torch.drivers.qgs_rp
"""

import time

import numpy as np

from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.parallel import distributed
from qgs_tpu_torch.parallel.mesh import process_rank


def main(dt=0.1, write_steps=5, transient_time=1.e5, integration_time=1.e4,
         filename="evol_fields.dat", mesh=None, device=None):
    """Spin up from a random state (``np.random.RandomState(21217)``, the
    draws of the seeded script), integrate the trajectory on the attractor
    (a record every ``write_steps`` steps) and write the times and the
    trajectory to ``filename`` as text (by the first process of a
    multi-process job).  ``mesh`` is the integrator's and ``device`` the
    tendencies' (default the card).  Returns the record times and the
    trajectory, on the host."""
    rng = np.random.RandomState(21217)
    T = time.perf_counter()

    print("Model qgs-tpu (atmosphere + orography configuration)")
    print("====================================================\n")
    print("Initialization ...")

    # Model parameters with non-default specs
    model_parameters = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi,
                                 'hd': 0.1})
    # Mode truncation at wavenumber 2 in both x and y
    model_parameters.set_atmospheric_channel_fourier_modes(2, 2)
    # Increase the orography depth and the meridional temperature gradient
    model_parameters.ground_params.set_orography(0.2, 1)
    model_parameters.atemperature_params.set_thetas(0.2, 0)
    model_parameters.print_params()

    f, Df = create_tendencies(model_parameters,
                              device="cuda" if device is None else device)

    integrator = RungeKuttaIntegrator(mesh=mesh)
    integrator.set_func(f)

    # Random initial condition -> transient to the attractor
    ic = rng.rand(model_parameters.ndim) * 0.1
    print("Starting the transient time integration...")
    integrator.integrate(0., transient_time, dt, ic=ic, write_steps=0)
    _, y = integrator.get_trajectories()

    # Trajectory on the attractor
    print("Starting the time evolution ...")
    integrator.integrate(0., integration_time, dt, ic=y,
                         write_steps=write_steps)
    t, traj = integrator.get_trajectories()
    traj = traj.cpu().numpy()

    print(f"Evolution finished, writing to file {filename}")
    if process_rank() == 0:
        np.savetxt(filename, np.concatenate([t[None, :], traj]).T)

    print("Time clock:")
    print(f"{time.perf_counter() - T:.2f} seconds")
    return t, traj


if __name__ == "__main__":
    distributed.initialize()
    main()
