"""The PyTorch port's tendency contraction and factory against the JAX
package: the same seeded inputs through ``qgs_tpu`` and ``qgs_tpu_torch``
on the CPU, float64, at the tendency tolerance of
``tests/test_trajectory.py:51`` (rtol 1e-12, atol 1e-14)."""

import numpy as np
import pytest
import torch

from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.utils.sparse import COO
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops.contraction import (MODES, from_numpy,
                                           make_tendency_fns, row_padded)

from tests.test_torch_host import both_params, maooam, rp

TOL = dict(rtol=1e-12, atol=1e-14)


@pytest.fixture(scope="module", params=[maooam, rp], ids=["maooam", "rp"])
def system(request):
    """The JAX package's tendencies and tensor, and the port's QgParams of
    the same configuration."""
    pars, port_pars = both_params(request.param)
    f, Df, qgt = jax_create_tendencies(pars, return_qgtensor=True)
    return port_pars, f, Df, qgt


def _states(ndim, B=5, seed=0):
    return np.random.default_rng(seed).random((B, ndim)) * 0.05


def test_batched_f_and_df_match_jax(system):
    pars, f, Df, qgt = system
    fp, jp = make_tendency_fns(qgt.tensor, qgt.jacobian_tensor, device="cpu")
    x = _states(pars.ndim)
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(fp(0., xt).numpy(),
                               np.asarray(f.batched(0., x)), **TOL)
    np.testing.assert_allclose(jp(0., xt).numpy(),
                               np.asarray(Df.batched(0., x)), **TOL)


def test_from_numpy_builds_the_same_tendency(system):
    pars, f, _, qgt = system
    t = qgt.tensor
    fp = from_numpy(np.asarray(t.coords), np.asarray(t.data), t.shape,
                    device="cpu")
    assert fp.dtype == torch.float64 and fp.device.type == "cpu"
    x = _states(pars.ndim, seed=1)
    np.testing.assert_allclose(fp(0., torch.as_tensor(x)).numpy(),
                               np.asarray(f.batched(0., x)), **TOL)


def test_create_tendencies_single_state_and_attributes(system):
    pars, f, Df, qgt = system
    fp, Dfp, qgt_p = create_tendencies(pars, return_qgtensor=True,
                                       device="cpu")
    x = _states(pars.ndim, B=1, seed=2)[0]
    xt = torch.as_tensor(x)
    assert fp(0., xt).shape == (pars.ndim,)
    np.testing.assert_allclose(fp(0., xt).numpy(), np.asarray(f(0., x)), **TOL)
    np.testing.assert_allclose(Dfp(0., xt).numpy(), np.asarray(Df(0., x)),
                               **TOL)
    assert fp.qgtensor is qgt_p and Dfp.qgtensor is qgt_p
    assert np.array_equal(qgt_p.tensor.data, qgt.tensor.data)
    assert fp.batched(0., xt[None]).shape == (1, pars.ndim)


@pytest.mark.parametrize("mode", MODES)
def test_every_jax_mode_name_runs_the_one_path(mode):
    pars = rp(QgParams)
    f_ref, _ = create_tendencies(pars, device="cpu")
    f_mode, _ = create_tendencies(pars, mode=mode, device="cpu")
    x = torch.as_tensor(_states(pars.ndim, seed=3))
    assert torch.equal(f_mode.batched(0., x), f_ref.batched(0., x))


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown contraction mode"):
        create_tendencies(rp(QgParams), mode="sparse", device="cpu")


def test_float32_tendency_close_to_float64(system):
    pars, f, _, qgt = system
    fp32, _ = make_tendency_fns(qgt.tensor, qgt.jacobian_tensor,
                                dtype=torch.float32, device="cpu")
    x = _states(pars.ndim, seed=4)
    out = fp32(0., torch.as_tensor(x, dtype=torch.float32))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(f.batched(0., x)),
                               rtol=1e-5, atol=1e-7)


def test_row_padded_layout():
    vals, (ja, kb) = row_padded([2, 0, 2, 2], 4, [[1, 2, 3, 4], [5, 6, 7, 8]],
                                [1., 2., 3., 4.])
    assert vals.shape == (4, 3)
    assert vals[2].tolist() == [1., 3., 4.] and vals[0].tolist() == [2., 0., 0.]
    assert ja[2].tolist() == [1, 3, 4] and kb[0].tolist() == [6, 0, 0]
    assert not vals[1].any() and not vals[3].any()


def test_rank5_tensor_raises_not_implemented():
    """A rank-5 tensor no longer raises: the one-entry quartic tendency
    ``f_1 = 2 x_1^2 x_2^2`` and its Jacobian tensor evaluate exactly."""
    t5 = COO(np.array([[1], [1], [1], [2], [2]]), np.array([2.]), (3,) * 5)
    j5 = COO(np.array([[1, 1], [1, 2], [1, 1], [2, 1], [2, 2]]),
             np.array([4., 4.]), (3,) * 5)
    f, jac = make_tendency_fns(t5, j5, device="cpu")
    x = torch.tensor([[3., 5.]], dtype=torch.float64)
    assert f(0., x).tolist() == [[2. * 9 * 25, 0.]]
    assert jac(0., x).tolist() == [[[4. * 3 * 25, 4. * 9 * 5], [0., 0.]]]


def test_t4_configuration_raises_not_implemented():
    """A T4 configuration no longer raises ``NotImplementedError``; with
    analytic inner products it raises the reference's ``ValueError``."""
    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8}, T4=True)
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    with pytest.raises(ValueError, match="need symbolic inner products"):
        create_tendencies(pars, device="cpu")
