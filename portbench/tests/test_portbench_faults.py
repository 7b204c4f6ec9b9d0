"""The comparison refuses a broken timed path.  Each cell is driven on the
CPU at a tiny size with the harness's look for a card skipped and the
program's entry (``RungeKuttaIntegrator`` or ``LyapunovsEstimator``)
broken underneath, once for each fault the cell can have, and ``correct``
comes out false; unbroken, it comes out true.  The faults: a step that
returns its state unchanged (every record the initial state), half of
the ensemble left out (its records zero), and one answer altered where
it is produced (one recorded value of one member off by 1% of its
variable's largest magnitude).  One card, so no exchange between cards
to leave out."""

import numpy as np
import pytest
import torch

from portbench.tests.conftest import CELLS, run_cpu


def unchanged(traj, ic):
    x0 = torch.as_tensor(np.asarray(ic)).to(traj)
    return x0[..., None].expand_as(traj).clone()


def half_left_out(traj, ic):
    traj = traj.clone()
    traj[traj.shape[0] // 2:] = 0
    return traj


def altered(traj, ic):
    traj = traj.clone()
    traj[-1, 0, -1] += 0.01 * traj[:, 0].abs().max()
    return traj


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out,
          "altered": altered}


class BrokenIntegrator:
    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault

    def integrate(self, t0, t, dt, ic=None, write_steps=1):
        self.inner.integrate(t0, t, dt, ic=ic, write_steps=write_steps)
        times, traj = self.inner.get_trajectories()
        self.result = times, self.fault(traj, ic)

    def get_trajectories(self):
        return self.result


class BrokenEstimator:
    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault

    def compute_lyapunovs(self, t0, tw, t, dt, mdt, ic=None, write_steps=1):
        self.inner.compute_lyapunovs(t0, tw, t, dt, mdt, ic=ic,
                                     write_steps=write_steps)
        times, traj, exps, vecs = self.inner.get_lyapunovs()
        traj = torch.as_tensor(traj)
        broken = self.fault(traj, ic)
        if self.fault is unchanged:
            exps, vecs = np.zeros_like(exps), vecs[..., :1].repeat(
                vecs.shape[-1], -1)
        elif self.fault is half_left_out:
            exps, vecs = (half_left_out(torch.as_tensor(a), ic).numpy()
                          for a in (exps, vecs))
        self.result = times, broken.numpy(), exps, vecs

    def get_lyapunovs(self):
        return self.result


def breaking(fault):
    def edit_job(job, ctx):
        if hasattr(job, "integrator"):
            job.integrator = BrokenIntegrator(job.integrator, fault)
        else:
            job.estimator = BrokenEstimator(job.estimator, fault)
    return edit_job


@pytest.mark.parametrize("name", CELLS)
def test_sound(name):
    assert run_cpu(name)["correct"] is True


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_refused(name, fault):
    result = run_cpu(name, edit_job=breaking(FAULTS[fault]))
    assert result["correct"] is False
    failed = [k for k, c in result["checks"].items()
              if c["value"] > c["limit"]]
    assert failed and "path_faults" not in failed


@pytest.mark.parametrize("name", CELLS)
def test_wrong_kernel_path_is_refused(name):
    def expect_a_launch(cell):
        from portbench.tests.conftest import shrink
        shrink(cell)
        cell["workload"]["expect_launches"]["k2_resident"] = 1
    result = run_cpu(name, edit=expect_a_launch)
    assert result["correct"] is False
    assert result["checks"]["path_faults"]["value"] == result["attempted"]
    assert result["failed"] == result["attempted"]
