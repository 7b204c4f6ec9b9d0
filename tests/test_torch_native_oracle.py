"""The port against its own native C++ oracle (``qgs_tpu_torch.native``,
the JAX package's C++ source byte for byte, built with
``-ffp-contract=off``, the reference's summation order): the tendency, and
single-trajectory RK4 over 300 steps of dt 0.1 with a record every 10
steps, for the float64 plain path and the double-float plain path.  Only
the summation order differs, so the limits are the trajectory tolerance of
``tests/test_trajectory.py:57`` (rtol 1e-9, atol 1e-11).  The oracle
itself is held bit for bit against the JAX package's NumPy backend, and
its source against the JAX package's.

The oracle is built at first use into the port's own build directory
(a temporary file per process, moved into place), so these tests skip only
where there is no ``g++``; a failed build fails them."""

import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from qgs_tpu.models.numpy_backend import (integrate_runge_kutta_numpy,
                                          make_numpy_tendencies)
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu_torch import native
from qgs_tpu_torch.integrators.rk import (integrate_runge_kutta,
                                         integrate_runge_kutta_df)
from qgs_tpu_torch.ops.contraction import from_numpy
from qgs_tpu_torch.ops.twofloat import DfTendency

from tests.test_trajectory import _maooam_params, _rp_params

TOL = dict(rtol=1e-9, atol=1e-11)
REPO = pathlib.Path(__file__).resolve().parents[1]


def needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("the native oracle needs g++")


@pytest.fixture(scope="module", params=[_maooam_params, _rp_params],
                ids=["maooam", "rp"])
def system(request):
    needs_gxx()
    pars = request.param()
    _, _, qgt = jax_create_tendencies(pars, return_qgtensor=True)
    return pars, qgt


def test_tendency_matches_native(system):
    pars, qgt = system
    t = qgt.tensor
    f_nat, _ = native.make_native_tendencies(t, qgt.jacobian_tensor)
    x = np.random.default_rng(12).random((4, pars.ndim)) * 0.05
    out = from_numpy(t.coords, t.data, t.shape, device="cpu")(
        0., torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), np.stack([f_nat(0., xi)
                                                      for xi in x]), **TOL)


@pytest.mark.parametrize("tier", ["float64", "twofloat"])
def test_plain_rk4_matches_native(system, tier):
    pars, qgt = system
    t = qgt.tensor
    x = np.random.default_rng(13).random((3, pars.ndim)) * 0.01
    if tier == "float64":
        times, traj = integrate_runge_kutta(
            from_numpy(t.coords, t.data, t.shape, device="cpu"), 0., 30.,
            0.1, x, write_steps=10)
    else:
        times, traj = integrate_runge_kutta_df(
            DfTendency(t.coords, t.data, t.shape, device="cpu"), 0., 30.,
            0.1, x, write_steps=10)
    assert len(times) == 31 and traj.dtype == torch.float64
    for b in range(3):
        y_nat, rec = native.rk4_integrate(t, x[b], 0.1, 300, write_steps=10)
        assert rec.shape == (31, pars.ndim)
        np.testing.assert_allclose(traj[b].numpy(), rec.T, **TOL)
        np.testing.assert_allclose(traj[b, :, -1].numpy(), y_nat, **TOL)


def test_source_equals_the_jax_packages():
    """The two oracles are one C++ source, so they cannot drift."""
    assert native.SOURCE.read_bytes() == (
        REPO / "qgs_tpu" / "native" / "qgs_kernels.cpp").read_bytes()


def test_oracle_bitwise_against_numpy_backend():
    """The port's oracle reproduces the JAX package's reference-order NumPy
    loops bit for bit (tendency and Jacobian; ``tests/test_trajectory.py:
    125-146``), and its RK4 their RK4 over 100 steps."""
    needs_gxx()
    pars = _maooam_params()
    _, _, qgt = jax_create_tendencies(pars, return_qgtensor=True)
    fn_c, Dfn_c = native.make_native_tendencies(qgt.tensor,
                                                qgt.jacobian_tensor)
    fn_p, Dfn_p = make_numpy_tendencies(qgt.tensor, qgt.jacobian_tensor)
    x = np.random.default_rng(3).random(pars.ndim) * 0.05
    assert np.array_equal(fn_c(0., x), fn_p(0., x))
    assert np.array_equal(Dfn_c(0., x), Dfn_p(0., x))

    _, y_py = integrate_runge_kutta_numpy(fn_p, 0., 10., 0.1, x,
                                          write_steps=0)
    y_c, rec = native.rk4_integrate(qgt.tensor, x, 0.1, 100, write_steps=10)
    np.testing.assert_allclose(y_c, y_py, rtol=1e-13, atol=1e-15)
    assert rec.shape[0] == 11
    assert np.array_equal(rec[0], x)


def test_concurrent_builds_never_expose_a_partial_library(tmp_path):
    """Four processes that build the oracle into an empty directory at once
    all load a whole library."""
    needs_gxx()
    script = ("import pathlib, sys\n"
              "from qgs_tpu_torch import native\n"
              "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
              "lib = native.load_library()\n"
              "print(lib.sparse_mul3 is not None)\n")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert all(o[0].strip() == "True" for o in outs)
    assert [p.name for p in tmp_path.iterdir()] == [
        native.library_path().name]
