"""The port's NumPy reference-semantics backend
(``qgs_tpu_torch.models.numpy_backend``, a copy of the JAX package's)
against ``qgs_tpu.models.numpy_backend``, bit for bit: the four sparse
contractions, both tendency factories and the RK integrator, on MAOOAM
(rank 3) and on the T4 configuration (rank 5), each tensor built by its
own package's host layers (``tests/test_torch_host.py``)."""

import numpy as np
import pytest

from qgs_tpu.models import numpy_backend as jax_nb
from qgs_tpu.tensors import qgtensor as jax_qgtensor
from qgs_tpu_torch.tensors import qgtensor as port_qgtensor
from qgs_tpu_torch.models import numpy_backend as port_nb

from tests.test_torch_host import (CONFIGS, JAX_IPS, PORT_IPS, SYMBOLIC,
                                   TENSORS, _tensor, both_params)


@pytest.fixture(scope="module", params=["maooam", "t4"])
def tensors(request):
    settings, ndim = CONFIGS[request.param]
    sym = request.param in SYMBOLIC
    cls, rank = TENSORS.get(request.param, ("QgsTensor", 3))
    jax_pars, port_pars = both_params(settings)
    t_jax = _tensor(jax_pars, *JAX_IPS[sym], getattr(jax_qgtensor, cls), sym)
    t_port = _tensor(port_pars, *PORT_IPS[sym], getattr(port_qgtensor, cls), sym)
    assert t_port.tensor.rank == rank
    return ndim, t_jax, t_port


def _states(ndim, seed, count=1):
    x = np.random.default_rng(seed).random((count, ndim)) * 0.05
    return np.concatenate([np.ones((count, 1)), x], axis=1)


def test_sparse_mul_equal(tensors):
    ndim, t_jax, t_port = tensors
    a, b, c, d = _states(ndim, 1, 4)
    ta, tp = t_jax.tensor, t_port.tensor
    ja, jp = t_jax.jacobian_tensor, t_port.jacobian_tensor
    if tp.rank == 3:
        pairs = [(jax_nb.sparse_mul3(ta.coords, ta.data, a, b),
                  port_nb.sparse_mul3(tp.coords, tp.data, a, b)),
                 (jax_nb.sparse_mul2(ja.coords, ja.data, c),
                  port_nb.sparse_mul2(jp.coords, jp.data, c))]
    else:
        pairs = [(jax_nb.sparse_mul5(ta.coords, ta.data, a, b, c, d),
                  port_nb.sparse_mul5(tp.coords, tp.data, a, b, c, d)),
                 (jax_nb.sparse_mul4(ja.coords, ja.data, a, b, c),
                  port_nb.sparse_mul4(jp.coords, jp.data, a, b, c))]
    for ref, got in pairs:
        assert got.shape == ref.shape and np.abs(ref).max() > 0
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("factory", ["make_numpy_tendencies",
                                     "make_numpy_tendencies_fast"])
def test_tendencies_equal(tensors, factory):
    ndim, t_jax, t_port = tensors
    f_j, Df_j = getattr(jax_nb, factory)(t_jax.tensor, t_jax.jacobian_tensor)
    f_p, Df_p = getattr(port_nb, factory)(t_port.tensor,
                                          t_port.jacobian_tensor)
    x = _states(ndim, 2)[0, 1:]
    assert f_p(0., x).shape == (ndim,)
    assert np.array_equal(f_p(0., x), f_j(0., x))
    assert Df_p(0., x).shape == (ndim, ndim)
    assert np.array_equal(Df_p(0., x), Df_j(0., x))


@pytest.mark.parametrize("write_steps, tableau", [(3, "rk4"), (0, "rk4"),
                                                  (1, "heun")])
def test_integrate_equal(tensors, write_steps, tableau):
    ndim, t_jax, t_port = tensors
    f_j, _ = jax_nb.make_numpy_tendencies(t_jax.tensor, t_jax.jacobian_tensor)
    f_p, _ = port_nb.make_numpy_tendencies(t_port.tensor,
                                           t_port.jacobian_tensor)
    ic = _states(ndim, 3, 2)[:, 1:]
    kw = dict(write_steps=write_steps)
    if tableau == "heun":
        kw.update(b=np.array([0.5, 0.5]), c=np.array([0., 1.]),
                  a=np.array([[0., 0.], [1., 0.]]))
    # rank 5 evaluates about 5,000 entries a call in a Python loop: 5 steps
    t_end = 1.05 if t_jax.tensor.rank == 3 else 0.45
    t_j, y_j = jax_nb.integrate_runge_kutta_numpy(f_j, 0., t_end, 0.1, ic,
                                                  **kw)
    t_p, y_p = port_nb.integrate_runge_kutta_numpy(f_p, 0., t_end, 0.1, ic,
                                                   **kw)
    assert np.array_equal(np.asarray(t_p), np.asarray(t_j))
    assert y_p.shape == y_j.shape and np.isfinite(y_p).all()
    assert np.array_equal(y_p, y_j)
