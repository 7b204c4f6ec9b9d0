"""Data-assimilation cycle job: each call is one cycle, the forecast of
the analysis ensemble (NumPy, (members, ndim)) by
``RungeKuttaIntegrator.integrate(t0, t1, dt, ic, write_steps)``, then
``get_trajectories`` and the records copied to the host as NumPy.  The
next cycle's analysis is the forecast's last state plus a perturbation
from a pool of ``perturbation_pool`` arrays of ``perturbation`` times
standard normals from the seed, taken in turn: it stands in for an
analysis step, and takes microseconds.  The first analysis is uniform in
[0, ``ic_scale``) from the seed, and its cycle (the warm-up) is compared
with the reference too (``compared_always``): a later cycle starts from
an analysis made of the program's own forecast.

Traffic parameters: ``members``, ``t0``, ``t1``, ``dt``, ``write_steps``,
``ic_scale``, ``perturbation``, ``perturbation_pool``."""

from portbench.harness import checks, work
from portbench.reference import qg


class Job:
    def __init__(self, ctx):
        from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator

        p, self.ctx = ctx.params, ctx
        n = ctx.config["ndim"]
        rng = ctx.rng(1)
        self.analysis = p["ic_scale"] * rng.random((p["members"], n))
        self.perturbations = [p["perturbation"] * rng.standard_normal(
            (p["members"], n)) for _ in range(p["perturbation_pool"])]
        steps = len(qg.time_grid(p["t0"], p["t1"], p["dt"])) - 1
        self.units_per_call = 1
        self.ops_per_call = p["members"] * steps * work.rk4_ops(
            n, ctx.frozen.coords)
        self.integrator = RungeKuttaIntegrator()
        self.integrator.set_func(ctx.f)
        self.compared_always = []

    def call(self, i):
        p, ic = self.ctx.params, self.analysis
        self.integrator.integrate(p["t0"], p["t1"], p["dt"], ic=ic,
                                  write_steps=p["write_steps"])
        _, traj = self.integrator.get_trajectories()
        forecast = traj.cpu().numpy()
        self.analysis = (forecast[:, :, -1]
                         + self.perturbations[i % len(self.perturbations)])
        if i == 0:
            self.compared_always.append((ic, forecast))
        return ic, forecast

    def reference(self, ics, dtype):
        """The reference's forecasts of the cycles whose analyses are
        ``ics``, all together."""
        p = self.ctx.params
        tendency = qg.Quadratic(self.ctx.frozen, dtype, self.ctx.device)
        return qg.by_members(lambda ic: qg.integrate(
            tendency, ic, p["t0"], p["t1"], p["dt"], p["write_steps"]), ics)

    def compare(self, out, ref):
        return {"traj_gap": checks.var_gap(out, ref)}
