"""On the card: one short run of a cell through ``run.py``, whose result
line says ``correct``; skipped where there is no card."""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import REPO


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")


@pytest.mark.cuda
def test_a_short_run(card):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "maooam36.da-f64",
         "--seed", str(2 ** 31 + 7), "--seconds", "2", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
