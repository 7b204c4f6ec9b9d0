"""The import check compares whole top-level names: JAX and the JAX
package are refused, the port (whose name begins with the JAX package's)
is not; and a run on the CPU with both blocked loads neither."""

import os
import subprocess
import sys

import pytest

from portbench.harness import guard
from portbench.tests.conftest import REPO


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib",
                                  "jaxlib.xla_client", "flax.linen",
                                  "qgs_tpu", "qgs_tpu.models.tendencies"])
def test_refused(name):
    assert guard.forbidden_modules([name, "numpy"]) == [name]


@pytest.mark.parametrize("name", ["qgs_tpu_torch", "qgs_tpu_torch.ops",
                                  "jaxtyping", "flaxen", "portbench"])
def test_accepted(name):
    assert guard.forbidden_modules([name]) == []


SCRIPT = r"""
import sys


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "qgs_tpu"):
            raise ImportError(f"{name} is blocked")


sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[1])
from portbench.harness import guard
from portbench.tests.conftest import CELLS, run_cpu
for name in CELLS:
    assert run_cpu(name)["correct"], name
assert not guard.forbidden_modules()
print("clean")
"""


def test_a_run_loads_neither():
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(REPO)],
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")
