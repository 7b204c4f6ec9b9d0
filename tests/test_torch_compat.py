"""The port's drop-in ``qgs`` namespace (``qgs_tpu_torch/compat.py``): after
``import qgs_tpu_torch.compat`` the reference's import paths resolve to the
port's modules, and a reference-style script runs on the port.

The alias is process-wide and the JAX package's ``compat`` installs one
too, so every check runs in a subprocess of its own, never in the pytest
process; the scripts block ``jax`` and ``qgs_tpu`` unless a check needs
the JAX package's alias."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu.params.params import QgParams as JaxQgParams

from tests.test_torch_host import rp

REPO = pathlib.Path(__file__).resolve().parents[1]

BLOCK = """
import sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
sys.modules["qgs_tpu"] = None      # and so does any of the JAX package
"""

# the reference import paths of tests/test_compat.py:14-23, and the ones
# this package adds (symbolic export, NumPy backend, native oracle)
PATHS = ["qgs.params.params", "qgs.functions.tendencies",
         "qgs.integrators.integrator", "qgs.tensors.qgtensor",
         "qgs.tensors.atmo_thermo_tensor", "qgs.functions.sparse_mul",
         "qgs.toolbox.lyapunov", "qgs.basis.fourier",
         "qgs.inner_products.analytic", "qgs.plotting.util",
         "qgs.functions.symbolic_tendencies", "qgs.functions.util",
         "qgs.tensors.symbolic_qgtensor", "qgs.native"]


def run(script, *args):
    env = {k: v for k, v in os.environ.items() if k != "QGS_TPU_X64"}
    proc = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()


def test_alias_is_real():
    """Every reference path is the port's own module object, the renames
    included, and no module of jax or the JAX package was imported."""
    script = BLOCK + f"""
import importlib
import qgs_tpu_torch.compat
for name in {PATHS!r}:
    alias = importlib.import_module(name)
    print(name, alias.__name__, alias is sys.modules[alias.__name__])
from qgs.params.params import QgParams
from qgs.functions.tendencies import create_tendencies
from qgs.integrators.integrator import RungeKuttaIntegrator
from qgs.tensors.qgtensor import QgsTensor
from qgs.tensors.atmo_thermo_tensor import AtmoThermoTensor
from qgs.functions.sparse_mul import sparse_mul2, sparse_mul3
from qgs.toolbox.lyapunov import LyapunovsEstimator
import qgs_tpu_torch.models.numpy_backend as nb
print("sparse_mul", sparse_mul3 is nb.sparse_mul3, sparse_mul2 is nb.sparse_mul2)
print("leaked", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "qgs_tpu")
                       and sys.modules[m] is not None))
"""
    lines = run(script)
    targets = {"qgs.tensors.atmo_thermo_tensor":
               "qgs_tpu_torch.tensors.atmo_thermo",
               "qgs.functions.sparse_mul": "qgs_tpu_torch.models.numpy_backend"}
    expect = [f"{p} {targets.get(p, 'qgs_tpu_torch' + p[3:])} True"
              for p in PATHS]
    assert lines == expect + ["sparse_mul True True", "leaked []"]


def test_reference_script_runs_on_the_port(tmp_path):
    """The reference entry scripts' import block (ref ``qgs_rp.py:23-30``)
    integrates 10 steps on the CPU; without ``device=`` the tendencies go
    to the card (and raise where there is none).  ``f(0, x)`` through the
    alias is the port's own, bit for bit, and the JAX package's to rtol
    1e-12."""
    out = tmp_path / "compat.npz"
    script = BLOCK + """
import numpy as np
import torch
import qgs_tpu_torch.compat
from qgs.params.params import QgParams
from qgs.integrators.integrator import RungeKuttaIntegrator
from qgs.functions.tendencies import create_tendencies
from qgs_tpu_torch.models import tendencies as port

# the qgs_rp.py channel (tests/test_torch_host.py, rp)
pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
pars.set_atmospheric_channel_fourier_modes(2, 2)
pars.ground_params.set_orography(0.2, 1)
pars.atemperature_params.set_thetas(0.2, 0)
f, Df = create_tendencies(pars, device="cpu")
integ = RungeKuttaIntegrator()
integ.set_func(f)
ic = np.random.default_rng(1).random((3, pars.ndim)) * 0.01
integ.integrate(0., 1., 0.1, ic=ic, write_steps=1)
t, traj = integ.get_trajectories()
assert tuple(traj.shape) == (3, pars.ndim, 11) and len(t) == 11
assert bool(traj.isfinite().all())
x = np.random.default_rng(2).random(pars.ndim) * 0.01
fx = f(0., torch.as_tensor(x))
f2, _ = port.create_tendencies(pars, device="cpu")
assert bool(torch.equal(fx, f2(0., torch.as_tensor(x))))
if torch.cuda.is_available():
    assert create_tendencies(pars)[0].batched.device.type == "cuda"
else:
    try:
        create_tendencies(pars)
    except (AssertionError, RuntimeError):
        pass
    else:
        raise SystemExit("create_tendencies landed on the CPU")
np.savez(sys.argv[1], x=x, fx=fx.numpy(), traj=traj.numpy())
print("OK")
"""
    assert run(script, out) == ["OK"]
    saved = np.load(out)
    f_jax, _ = jax_create_tendencies(rp(JaxQgParams))
    np.testing.assert_allclose(saved["fx"], np.asarray(f_jax(0., saved["x"])),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("first", ["jax_alias", "jax_modules"])
def test_install_refuses_another_qgs_alias(first):
    """After the JAX package's alias, or with ``qgs`` modules of another
    package in ``sys.modules``, installing the port's alias raises
    ``ImportError`` and leaves the other package's modules in place."""
    script = """
import sys
import qgs_tpu.compat
import qgs.params.params
"""
    if first == "jax_modules":
        script += """
sys.meta_path[:] = [f for f in sys.meta_path
                    if type(f).__module__ != "qgs_tpu.compat"]
"""
    script += """
try:
    import qgs_tpu_torch.compat
except ImportError as e:
    print("refused:", "another package" in str(e))
else:
    print("installed")
print(any(type(f).__module__ == "qgs_tpu_torch.compat"
          for f in sys.meta_path),
      sys.modules["qgs.params.params"].__name__.startswith("qgs_tpu_torch"))
"""
    assert run(script) == ["refused: True", "False False"]
