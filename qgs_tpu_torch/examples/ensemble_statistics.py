"""Ensemble integration and ensemble-mean observables
(counterpart of ``examples/ensemble_statistics.py``)."""

import numpy as np

from qgs_tpu_torch.examples import F64, cli, pyplot, savefig
from qgs_tpu_torch.examples.rp_atmosphere import params
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.integrators.statistics import TrajectoriesStatistics
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.parallel.mesh import ensemble_size

MEMBERS = 32
# time units: the one long transient, the members' reconvergence, the run
TIMES = {False: dict(convergence=2000., reconvergence=100., span=200.),
         True: dict(convergence=100., reconvergence=10., span=20.)}
TOLERANCES = {"ic": F64, "mean": F64, "second_moment": F64}


def main(device="cuda", short=False, plot=True, outdir="."):
    plt = pyplot() if plot else None
    times = TIMES[short]
    pars = params()
    f, Df = create_tendencies(pars, device=device)

    # An ensemble is one batched state on the device: every member runs in
    # the same kernel launch, split over the cards of the mesh.
    integrator = RungeKuttaIntegrator(number_of_dimensions=pars.ndim)
    integrator.set_func(f)

    # One long transient, its end state perturbed into the members, and a
    # brief reconvergence of all of them in one batched integration: much
    # cheaper than one long transient each.  (``initialize(...,
    # reconvergence_time=..., rng=...)`` does the same from a standard
    # normal draw; from a start that large, two summation orders' rounding
    # grows to differences of order 0.1 within 100 time units, so a run
    # could not be held against another device's.)  compute_stats averages
    # observables over the ensemble in batches (num=2 splits the members
    # into 2 batches).
    rng = np.random.default_rng(0)
    integrator.integrate(0., times["convergence"], 0.1,
                         ic=rng.random(pars.ndim) * 0.1, write_steps=0)
    _, x0 = integrator.get_trajectories()
    members = x0.cpu().numpy() + 0.01 * rng.standard_normal(
        (MEMBERS, pars.ndim))
    stats = TrajectoriesStatistics()
    stats.set_integrator(integrator)
    stats.initialize(times["reconvergence"], 0.1, ic=members)
    ic = stats.get_ic().cpu().numpy()
    stats.set_func_list([
        lambda traj: traj,                       # ensemble-mean trajectory
        lambda traj: traj ** 2,                  # second moment
    ])
    stats.compute_stats(0., times["span"], 0.1, write_steps=10, num=2)
    mean_traj, second_moment = (s.cpu().numpy() for s in stats.get_stats())
    variance = second_moment - mean_traj ** 2
    print("ensemble variance of psi_a_1 over time:")
    print(np.array2string(variance[0], precision=5))

    # How the ensemble is laid out: the integrator's mesh, every visible
    # card when the model is on a card (else its one device), takes a
    # contiguous share of the members each.
    mesh = integrator.mesh
    print("devices:", mesh.size, " mesh:", dict(mesh.shape))
    print("members per device:", MEMBERS // ensemble_size(mesh))

    if plot:
        # ensemble-spread growth, the practical measure of predictability
        fig, ax = plt.subplots(figsize=(7, 3.2))
        ax.semilogy(np.arange(variance.shape[-1]),
                    np.maximum(variance[0], 1e-12))
        ax.set_xlabel("record index (every 1 time unit)")
        ax.set_ylabel(r"ensemble var($\psi_{a,1}$)")
        ax.set_title("ensemble spread growth on the attractor")
        fig.tight_layout()
        savefig(plt, outdir, "ensemble_spread.png")
        print("wrote ensemble_spread.png")
    return dict(ic=ic, mean=mean_traj, second_moment=second_moment,
                variance=variance)


if __name__ == "__main__":
    cli(main)
