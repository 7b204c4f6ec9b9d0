"""Helpers of the benchmark's own tests: a cell run on the CPU at a tiny
size, with the kernels' launches not expected (the CPU runs the port's
plain step loop)."""

import pathlib
import sys
import time

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SEED = 2 ** 31 + 12345          # past 32 signed bits
CELLS = ("maooam36.ens-f64", "maooam228.ens-f64", "maooam36.lyap-f64",
         "maooam36.da-f64")


def shrink(cell):
    """The cell's traffic cut to a size the CPU runs in a second: 8
    members and a few records, every member compared; no kernel launch
    expected."""
    p = cell["traffic"]["params"]
    p["members"] = 8
    p.pop("reference_members", None)
    if cell["traffic"]["job"] == "lyapunov":
        p.update(t=4.0, ic_pool=2)
    elif cell["traffic"]["job"] == "ensemble":
        p.update(t1=4.0, write_steps=10, ic_pool=2)
    else:
        p.update(t1=2.0, perturbation_pool=3)
    wl = cell["workload"]
    wl["expect_launches"] = {k: 0 for k in wl["expect_launches"]}
    wl["trace_calls"] = 3
    wl["check"]["calls"] = 3


def run_cpu(name, trace=False, seconds=0.3, edit_job=None, edit=shrink,
            root=None):
    from portbench.harness import runner
    return runner.run(name, SEED, seconds, trace, t_start=time.perf_counter(),
                      device="cpu", root=root, edit=edit, edit_job=edit_job,
                      say=lambda line: None)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so that test workers do not
    oversubscribe the cores."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
