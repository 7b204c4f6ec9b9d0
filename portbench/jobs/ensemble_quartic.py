"""Ensemble job of a rank-5 (quartic) model: the ``ensemble`` job's
contract (``RungeKuttaIntegrator.integrate`` of the whole ensemble, then
``get_trajectories``; a pool of ``ic_pool`` initial ensembles taken in
turn; ``traj_gap_first`` and ``traj_gap`` compared), with three
differences:

* the initial states are uniform in [0, ``ic_scale``) from the seed, with
  each variable named in ``set_vars`` (``{"<index>": value}``, indices of
  the state) set to its value, as the models' ``initial_state`` sets the
  prognostic 0-th order temperatures, which are not near zero;
* the reference is :class:`quartic.Quartic`;
* under the control, whose stand-in integrator carries the rank-3
  reference, that stand-in's tendency is replaced by
  :class:`quartic.Quartic` in the stand-in's dtype.

Traffic parameters: the ``ensemble`` job's and ``set_vars``.  The job
gives the readers ``steps_per_call`` and ``rk4_bound_s``, the least time
the card could take for a call's RK4 steps (``work.rk4_work``), whatever
implements them."""

from portbench.harness import loader, work
from portbench.reference import qg, quartic, stand_in

Base = loader.job("ensemble").Job


class Job(Base):
    def __init__(self, ctx):
        super().__init__(ctx)
        p, n = ctx.params, ctx.config["ndim"]
        for var, value in p.get("set_vars", {}).items():
            for ic in self.pool:
                ic[:, int(var)] = value
        self.steps_per_call = len(qg.time_grid(p["t0"], p["t1"],
                                               p["dt"])) - 1
        flops, n_bytes = work.rk4_work(
            p["members"], n, ctx.frozen.coords, self.steps_per_call, 8,
            records=self.steps_per_call // p["write_steps"])
        self.rk4_bound_s = work.bound_s(flops, n_bytes,
                                        work.PEAK_F64_VECTOR)[0]

    @property
    def integrator(self):
        return self._integrator

    @integrator.setter
    def integrator(self, value):
        if isinstance(value, stand_in.Integrator):
            value.tendency = quartic.Quartic(self.ctx.frozen,
                                             value.tendency.dtype,
                                             value.tendency.device)
        self._integrator = value

    def reference(self, keys, dtype):
        """The reference's records of the compared members of the calls
        ``keys``, each pool ensemble integrated once, all together."""
        p, distinct = self.ctx.params, sorted(set(keys))
        tendency = quartic.Quartic(self.ctx.frozen, dtype, self.ctx.device)
        refs = qg.by_members(lambda ic: qg.integrate(
            tendency, ic, p["t0"], p["t1"], p["dt"], p["write_steps"]),
            [self.pool[k][self.members] for k in distinct])
        return [refs[distinct.index(k)] for k in keys]
