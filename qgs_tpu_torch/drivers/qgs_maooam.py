#!/usr/bin/env python
"""
MAOOAM coupled ocean-atmosphere model run
=========================================

The port's counterpart of the repository's ``qgs_maooam.py``: the
36-variable coupled ocean-atmosphere model (De Cruz, Demaeyer & Vannitsem
2016) on the card, each integration one launch of the fused RK4 kernel a
device.  Set ``QGS_ENSEMBLE`` to integrate an ensemble of perturbed
initial conditions split across the visible cards (the integrator's
default mesh), or across the processes of a ``torchrun`` job::

    python -m qgs_tpu_torch.drivers.qgs_maooam
    QGS_ENSEMBLE=4096 torchrun --nproc_per_node=4 -m qgs_tpu_torch.drivers.qgs_maooam
"""

import os
import time

import numpy as np

from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.parallel import distributed
from qgs_tpu_torch.parallel.mesh import process_rank


def main(dt=0.1, write_steps=100, transient_time=3.e6, integration_time=5.e5,
         ensemble=None, filename="evol_fields.dat", mesh=None, device=None):
    """Spin up from a random state (``np.random.RandomState(210217)``, the
    draws of the seeded script), integrate the evolution and write it to
    ``filename`` (times and one trajectory as text), or, for an ensemble
    of ``ensemble`` members (default ``QGS_ENSEMBLE``, else 1), the (B, 36,
    n_records) trajectories to the ``.npy`` of the same name (by the
    first process of a multi-process job).  ``mesh`` is the integrator's
    (default every visible card) and ``device`` the tendencies' (default
    the card).  Returns the record times and the trajectories, on the
    host."""
    if ensemble is None:
        ensemble = int(os.environ.get("QGS_ENSEMBLE", "1"))
    rng = np.random.RandomState(210217)
    T = time.perf_counter()

    print("Model qgs-tpu (atmosphere + ocean (MAOOAM) configuration)")
    print("=========================================================\n")
    print("Initialization ...")

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
    model_parameters.print_params()

    f, Df = create_tendencies(model_parameters,
                              device="cuda" if device is None else device)

    integrator = RungeKuttaIntegrator(mesh=mesh)
    integrator.set_func(f)

    ic = rng.rand(model_parameters.ndim) * 0.01
    if ensemble > 1:
        ic = ic[None, :] + 1e-4 * rng.randn(ensemble, model_parameters.ndim)

    print("Starting the transient time integration...")
    integrator.integrate(0., transient_time, dt, ic=ic, write_steps=0)
    _, y = integrator.get_trajectories()

    print("Starting the time evolution ...")
    integrator.integrate(0., integration_time, dt, ic=y,
                         write_steps=write_steps)
    t, traj = integrator.get_trajectories()
    traj = traj.cpu().numpy()

    print(f"Evolution finished, writing to file {filename}")
    if process_rank() == 0:
        if traj.ndim == 2:
            np.savetxt(filename, np.concatenate([t[None, :], traj]).T)
        else:
            np.save(filename.replace(".dat", ".npy"), traj)

    print("Time clock:")
    print(f"{time.perf_counter() - T:.2f} seconds")
    return t, traj


if __name__ == "__main__":
    distributed.initialize()
    main()
