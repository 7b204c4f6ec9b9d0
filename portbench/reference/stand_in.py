"""The plain reference with the calls of the port's API that the jobs
make, to stand in the program's place: the control (the reference in a
lower precision than the configuration's, which the comparison has to
refuse) and the tests run the harness with these."""

from __future__ import annotations

import numpy as np

from portbench.reference import qg


class Integrator:
    """``integrate`` and ``get_trajectories`` of ``RungeKuttaIntegrator``
    by :func:`qg.integrate` in ``dtype``."""

    def __init__(self, tensor, dtype, device):
        self.tendency = qg.Quadratic(tensor, dtype, device)
        self.result = None

    def integrate(self, t0, t, dt, ic=None, write_steps=1):
        grid = qg.time_grid(t0, t, dt)
        times = grid[qg.record_index(len(grid), write_steps)]
        self.result = times, qg.integrate(self.tendency, ic, t0, t, dt,
                                          write_steps)

    def get_trajectories(self):
        return self.result


class Estimator:
    """``compute_lyapunovs`` and ``get_lyapunovs`` of
    ``LyapunovsEstimator`` by :func:`qg.backward_lyapunov` in ``dtype``."""

    def __init__(self, tensor, dtype, device):
        self.tendency = qg.Quadratic(tensor, dtype, device)
        self.result = None

    def compute_lyapunovs(self, t0, tw, t, dt, mdt, ic=None, write_steps=1):
        n_rec = int(round((t - tw) / dt))
        times = tw + dt * np.arange(n_rec + 1)
        self.result = (times[qg.record_index(n_rec + 1, write_steps)],
                       *qg.backward_lyapunov(self.tendency, ic, t0, tw, t,
                                             dt, mdt, write_steps))

    def get_lyapunovs(self):
        times, *rest = self.result
        return (times, *(x.cpu().numpy() for x in rest))
