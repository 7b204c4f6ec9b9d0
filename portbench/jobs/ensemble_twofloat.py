"""Ensemble job in double-float: the ``ensemble`` job's contract
(``RungeKuttaIntegrator.integrate`` of the whole ensemble, then
``get_trajectories``; a pool of ``ic_pool`` initial ensembles taken in
turn; ``traj_gap_first`` and ``traj_gap``), the integrator built with
``precision="twofloat"``: the port's double-float tier (about 48 bits of
mantissa, five fewer than float64), whose records come back as float64.

The reference is the extended-precision one
(``portbench/reference/extended.py``, NumPy ``longdouble``) on
``reference_members`` members drawn from the seed, so that the gap read is
the program's own rounding and not a float64 reference's too.

Traffic parameters: the ``ensemble`` job's."""

import numpy as np
import torch

from portbench.harness import loader
from portbench.reference import extended

Base = loader.job("ensemble").Job


class Job(Base):
    def __init__(self, ctx):
        from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator

        super().__init__(ctx)
        self.integrator = RungeKuttaIntegrator(precision="twofloat")
        self.integrator.set_func(ctx.f)

    def reference(self, keys, dtype):
        """The extended-precision records of the compared members of the
        calls ``keys``, each pool ensemble integrated once, rounded to
        float64 for the comparison; ``dtype`` is not used."""
        p, distinct = self.ctx.params, sorted(set(keys))
        tendency = extended.Quadratic(self.ctx.frozen)
        refs = [torch.as_tensor(extended.integrate(
            tendency, self.pool[k][self.members], p["t0"], p["t1"], p["dt"],
            p["write_steps"]).astype(np.float64)) for k in distinct]
        return [refs[distinct.index(k)] for k in keys]
