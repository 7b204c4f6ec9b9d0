"""Lyapunov job: ``LyapunovsEstimator().compute_lyapunovs(t0, tw, t, dt,
mdt, ic, write_steps)`` over the full spectrum (``n_vec`` the model's
ndim), then ``get_lyapunovs`` (NumPy).  Each call is ``(t - t0) / dt``
Benettin windows, the transient's and the recorded ones.  The initial
ensembles are a pool of ``ic_pool`` NumPy arrays, uniform in [0,
``ic_scale``) from the seed.  The reference runs on the host's CPU (the
card's QR of small matrices is slower than the host's).

Traffic parameters: ``members``, ``t0``, ``tw``, ``t``, ``dt``, ``mdt``,
``write_steps``, ``ic_scale``, ``ic_pool``."""

from portbench.harness import checks, work
from portbench.reference import qg


class Job:
    def __init__(self, ctx):
        from qgs_tpu_torch.toolbox.lyapunov import LyapunovsEstimator

        p, self.ctx = ctx.params, ctx
        n = ctx.config["ndim"]
        rng = ctx.rng(1)
        self.pool = [p["ic_scale"] * rng.random((p["members"], n))
                     for _ in range(p["ic_pool"])]
        windows = int(round((p["t"] - p["t0"]) / p["dt"]))
        n_sub = int(round(p["dt"] / p["mdt"]))
        self.windows_per_call = windows
        self.units_per_call = p["members"] * windows
        self.ops_per_call = self.units_per_call * work.tgls_window_ops(
            n, ctx.frozen.coords, n, n_sub)
        self.estimator = LyapunovsEstimator()
        self.estimator.set_func(ctx.f, ctx.Df)

    def call(self, i):
        p, key = self.ctx.params, i % len(self.pool)
        self.estimator.compute_lyapunovs(
            p["t0"], p["tw"], p["t"], p["dt"], p["mdt"], ic=self.pool[key],
            write_steps=p["write_steps"])
        return key, self.estimator.get_lyapunovs()

    def reference(self, keys, dtype):
        """The reference's ``(traj, exponents, vectors)`` of the calls
        ``keys``, each pool ensemble once, all together."""
        p, distinct = self.ctx.params, sorted(set(keys))
        tendency = qg.Quadratic(self.ctx.frozen, dtype, "cpu")
        refs = qg.by_members(lambda ic: qg.backward_lyapunov(
            tendency, ic, p["t0"], p["tw"], p["t"], p["dt"], p["mdt"],
            p["write_steps"]), [self.pool[k] for k in distinct])
        return [refs[distinct.index(k)] for k in keys]

    def compare(self, out, ref):
        if len(out) == 4:              # the program's: (times, traj, exps, vecs)
            out = out[1:]
        traj, exps, vecs = out
        return {"traj_gap": checks.var_gap(traj, ref[0]),
                "exp_gap": checks.scaled_gap(exps, ref[1]),
                "vec_gap": checks.column_gap(vecs, ref[2])}
