"""Distributed ensembles: the ('ensemble', 'model') device mesh, the
row-sharded tendency and a two-process run (counterpart of
``examples/distributed_ensembles.py``).

In a job of several processes (``torchrun``, one process a card) every
process runs the same script and
:func:`qgs_tpu_torch.parallel.distributed.initialize` joins them.  This
walkthrough runs in one process on a mesh whose eight entries all name the
one device it was given; a mesh may name a device more than once, and then
its shards run one after the other there.  At the end it spawns a real
two-process run over gloo.
"""

import numpy as np
import torch

from qgs_tpu_torch.examples import F64, cli
from qgs_tpu_torch.examples.maooam_coupled import params
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.integrators.rk import make_rk_step, rk4_tableau
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.parallel.distributed import (gather_to_host,
                                                host_chip_mesh,
                                                make_global_array,
                                                run_multiprocess_selftest)
from qgs_tpu_torch.parallel.sharded_tendency import make_sharded_tendency

B = 8
TIMES = {False: dict(span=100.), True: dict(span=10.)}
TOLERANCES = {"traj": F64, "sharded_step": F64}


def main(device="cuda", short=False, plot=True, outdir=".", selftest=True):
    # nothing is drawn: plot and outdir are accepted for the common call
    times = TIMES[short]
    # The mesh: a 2-D ('ensemble', 'model') grid in which each model group
    # lives inside one process, so that the model axis's gathers stay on
    # one host and only the ensemble axis spans processes.
    mesh = host_chip_mesh(model_axis_size=2, devices=[device] * 8)
    print("mesh axes:", dict(mesh.shape))

    # The model is built as usual: nothing about it knows the mesh.
    pars = params()
    f, Df, tensor = create_tendencies(pars, return_qgtensor=True,
                                      device=device)

    # The integrator splits the members over the mesh's ensemble axis: a
    # copy of the tendency on each entry's device, one launch of the fused
    # RK4 kernel a shard, the records gathered on the first device.
    ic = np.random.default_rng(7).random((B, pars.ndim)) * 0.01
    integ = RungeKuttaIntegrator(mesh=mesh)
    integ.set_func(f)
    integ.integrate(0., times["span"], 0.1, ic=ic, write_steps=100)
    t, traj = integ.get_trajectories()
    print("trajectories:", tuple(traj.shape), "finite:",
          bool(torch.isfinite(traj).all()))

    # The model axis shards the contraction itself: each entry holds whole
    # rows of the tensor, and a stage's outputs are gathered across the
    # model group (disjoint rows: one gather, no sum).
    f_sh = make_sharded_tendency(tensor.tensor, mesh)
    a, b, c = rk4_tableau()
    # this process's block of the ensemble: in one process, every shard
    x = torch.cat(make_global_array(ic, mesh))
    y = make_rk_step(f_sh, a, b, c)(x, 0.0, 0.1)
    y_ref = make_rk_step(f.batched, a, b, c)(
        torch.as_tensor(ic, device=device), 0.0, 0.1)
    y = gather_to_host(y)
    err = float(np.abs(y - y_ref.cpu().numpy()).max())
    print(f"mode-sharded RK4 step vs replicated: max |diff| = {err:.2e}")

    # Two OS processes joined by torch.distributed over gloo, each driving
    # two entries (on a card, both processes share it): the ensemble axis
    # spans the processes, each process's two entries form a model group.
    reports = []
    if selftest:
        reports = run_multiprocess_selftest(
            num_processes=2, local_devices=2, model_axis_size=2,
            device=torch.device(device).type)
        for line in reports:
            print(line)
    return dict(traj=traj.cpu().numpy(), sharded_step=y, err=err,
                reports=reports)


if __name__ == "__main__":
    cli(main, selftest=True)
