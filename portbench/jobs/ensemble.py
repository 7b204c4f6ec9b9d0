"""Ensemble job: ``RungeKuttaIntegrator.integrate(t0, t1, dt, ic,
write_steps)`` of the whole ensemble, then ``get_trajectories``; a call
ends when its records are on the device.  The initial ensembles are a
pool of ``ic_pool`` NumPy arrays, uniform in [0, ``ic_scale``) from the
seed (qgs_maooam.py's start), the calls taking them in turn.

Traffic parameters: ``members``, ``t0``, ``t1``, ``dt``, ``write_steps``,
``ic_scale``, ``ic_pool``; ``reference_members``, the members of each
compared call that the reference integrates, drawn from the seed (all
when absent).

Two numbers are compared: ``traj_gap_first``, the gap of the first record
after the start (``write_steps`` steps in, before a model's instability
has grown the rounding of the summation order), and ``traj_gap``, the gap
over all the records."""

import numpy as np

from portbench.harness import checks, work
from portbench.reference import qg


class Job:
    def __init__(self, ctx):
        from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator

        p, self.ctx = ctx.params, ctx
        n = ctx.config["ndim"]
        rng = ctx.rng(1)
        self.pool = [p["ic_scale"] * rng.random((p["members"], n))
                     for _ in range(p["ic_pool"])]
        steps = len(qg.time_grid(p["t0"], p["t1"], p["dt"])) - 1
        coords = ctx.frozen.coords
        self.units_per_call = p["members"] * steps
        self.ops_per_call = self.units_per_call * work.rk4_ops(n, coords)
        flops, n_bytes = work.rk4_work(p["members"], n, coords, steps, 8,
                                       records=steps // p["write_steps"])
        self.k1_bound_s = work.bound_s(flops, n_bytes,
                                       work.PEAK_F64_VECTOR)[0]
        m = p.get("reference_members", p["members"])
        self.members = (slice(None) if m == p["members"] else
                        np.sort(ctx.rng(2).choice(p["members"], m,
                                                  replace=False)))
        self.integrator = RungeKuttaIntegrator()
        self.integrator.set_func(ctx.f)

    def call(self, i):
        p, key = self.ctx.params, i % len(self.pool)
        self.integrator.integrate(p["t0"], p["t1"], p["dt"],
                                  ic=self.pool[key],
                                  write_steps=p["write_steps"])
        _, traj = self.integrator.get_trajectories()
        self.ctx.sync()
        return key, traj

    def reference(self, keys, dtype):
        """The reference's records of the compared members of the calls
        ``keys``, each pool ensemble integrated once, all together."""
        p, distinct = self.ctx.params, sorted(set(keys))
        tendency = qg.Quadratic(self.ctx.frozen, dtype, self.ctx.device)
        refs = qg.by_members(lambda ic: qg.integrate(
            tendency, ic, p["t0"], p["t1"], p["dt"], p["write_steps"]),
            [self.pool[k][self.members] for k in distinct])
        return [refs[distinct.index(k)] for k in keys]

    def compare(self, out, ref):
        if out.shape[0] == self.ctx.params["members"]:
            out = out[self.members]        # the program's: every member
        return {"traj_gap_first": checks.var_gap(out[..., 1], ref[..., 1]),
                "traj_gap": checks.var_gap(out, ref)}
