"""
Trajectory ensemble statistics
==============================

Counterpart of :mod:`qgs_tpu.integrators.statistics` (ref
``qgs/integrators/statistics.py:7-77``): the ensemble of initial conditions
is split into ``num`` consecutive batches, each integrated by the port's
integrator and reduced with the user's observables, on the integration's
device.
"""

from __future__ import annotations

import numpy as np
import torch


class TrajectoriesStatistics:
    """Ensemble-mean observables over batches of trajectories."""

    def __init__(self):
        self.ic = None
        self.integrator = None
        self.func_list = []
        self.mean_func = []

    def set_integrator(self, integrator):
        """Set the integrator (a
        :class:`~qgs_tpu_torch.integrators.integrator.RungeKuttaIntegrator`
        with its function set)."""
        self.integrator = integrator

    def set_func_list(self, func_list):
        """Observables ``f(traj)`` of the (B, ndim, n_rec) trajectory
        tensor, each returning a tensor whose first axis is the
        trajectories'."""
        self.func_list = list(func_list)

    def set_ic(self, ic):
        self.ic = torch.atleast_2d(ic) if torch.is_tensor(ic) \
            else np.atleast_2d(np.asarray(ic))

    def get_ic(self):
        return self.ic

    def initialize(self, convergence_time, dt, pert_size=0.01,
                   reconvergence_time=None, number_of_trajectories=1,
                   ic=None, rng=None):
        """Spin the ensemble onto the attractor through the integrator
        (random initial states are drawn from ``rng``, a
        :class:`numpy.random.Generator`, when ``ic`` is not given)."""
        self.integrator.initialize(
            convergence_time, dt, pert_size=pert_size,
            reconvergence_time=reconvergence_time,
            number_of_trajectories=number_of_trajectories, ic=ic,
            reconverge=reconvergence_time is not None, rng=rng)
        self.ic = self.integrator.ic

    def compute_stats(self, t0, t, dt, ic=None, forward=True, write_steps=1,
                      num=1):
        """Integrate the ensemble in ``num`` batches and average each
        observable over the trajectories of each batch, then over the
        batches; returns the stacked means, a tensor on the integration's
        device."""
        if ic is not None:
            self.set_ic(ic)
        ends = np.cumsum([0] + [len(b) for b in np.array_split(
            np.arange(self.ic.shape[0]), num)]).tolist()
        chunks = None
        for lo, hi in zip(ends[:-1], ends[1:]):
            self.integrator.integrate(t0, t, dt, ic=self.ic[lo:hi],
                                      forward=forward, write_steps=write_steps)
            _, traj = self.integrator.get_trajectories()
            if traj.ndim == 2:
                traj = traj[None]
            vals = [torch.as_tensor(f(traj), device=traj.device).mean(dim=0)
                    for f in self.func_list]
            if chunks is None:
                chunks = [[v] for v in vals]
            else:
                for store, v in zip(chunks, vals):
                    store.append(v)

        self.mean_func = torch.stack([torch.stack(c).mean(dim=0)
                                      for c in chunks])
        return self.mean_func

    def get_stats(self):
        return self.mean_func
