"""The port against the JAX package's native C++ oracle
(``qgs_tpu.native``, built with ``-ffp-contract=off``, the reference's
summation order): the tendency, and single-trajectory RK4 over 300 steps
of dt 0.1 with a record every 10 steps, for the float64 plain path and the
double-float plain path.  Only the summation order differs, so the limits
are the trajectory tolerance of ``tests/test_trajectory.py:57`` (rtol
1e-9, atol 1e-11)."""

import numpy as np
import pytest
import torch

from qgs_tpu import native
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu_torch.integrators.rk import (integrate_runge_kutta,
                                         integrate_runge_kutta_df)
from qgs_tpu_torch.ops.contraction import from_numpy
from qgs_tpu_torch.ops.twofloat import DfTendency

from tests.test_trajectory import _maooam_params, _rp_params

TOL = dict(rtol=1e-9, atol=1e-11)


@pytest.fixture(scope="module", params=[_maooam_params, _rp_params],
                ids=["maooam", "rp"])
def system(request):
    if not native.available():
        pytest.skip("the native oracle needs a C++ compiler")
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
