"""The control: the plain reference one precision below the
configuration's (float32 for float64) in the program's place.  At a size
a test holds, on the CPU, each cell's comparison refuses it: the tensor
rounded to float32 fails its limit, and so does at least one of the
numbers of the outputs (the control has to fail one of a cell's numbers,
not each: the chaotic ndim-228 ensemble's all-record limit lies above
what float32 drifts over a test's few steps)."""

import time

import pytest

from portbench import control
from portbench.harness import runner
from portbench.tests.conftest import CELLS, SEED, shrink


@pytest.mark.parametrize("name", CELLS)
def test_control_is_refused(name):
    def edit(cell):
        shrink(cell)
        control.no_launches(cell)

    result = runner.run(name, SEED, 0.3, False, t_start=time.perf_counter(),
                        device="cpu", edit=edit,
                        edit_job=control.stand_in,
                        say=lambda line: None)
    assert result["correct"] is False
    failed = {k for k, c in result["checks"].items()
              if c["value"] > c["limit"]}
    assert "tensor_gap" in failed and len(failed) >= 2
