"""The port's symbolic examples (``qgs_tpu_torch.examples``:
``custom_basis``, ``symbolic_export`` and ``auto_continuation``) against
the JAX package's computation.

Each test runs the port's ``main(device="cpu", short=True, plot=False)``
and rebuilds the JAX example's computation with ``qgs_tpu`` from the same
parameters and the same seeded NumPy inputs (the JAX scripts are neither
run nor edited).  The exported strings must be equal.  A SymPy export
costs about 15 s a package, so the JAX package's runs once for this
module, in python with its equations kept, and its Fortran and AUTO-07p
texts are emitted from those equations by its own
``equation_as_function``, as the port's examples do.  The custom basis's
mass matrix is bit for bit the JAX package's and its tendencies agree to
rtol 1e-13 (only the summation order differs); the generated code stays
within the JAX script's bound of the numeric tendencies (1e-8), which
agree with the JAX package's to rtol 1e-13."""

import jax.numpy as jnp
import numpy as np
import pytest
from sympy import exp, pi, sin, symbols

from qgs_tpu.basis.base import SymbolicBasis as JaxBasis
from qgs_tpu.functions import symbolic_tendencies as jax_sym
from qgs_tpu.inner_products.definition import (
    StandardSymbolicInnerProductDefinition as JaxDefinition)
from qgs_tpu.inner_products.symbolic import (
    AtmosphericSymbolicInnerProducts as JaxAtmSymbolic)
from qgs_tpu.models.tendencies import create_tendencies as jax_tendencies
from qgs_tpu.ops.contraction import make_tendency_fns as jax_fns
from qgs_tpu.params.params import QgParams as JaxQgParams
from qgs_tpu.tensors.qgtensor import QgsTensor as JaxQgsTensor

from tests.test_torch_examples_models import one_torch_thread  # noqa: F401
from qgs_tpu_torch.examples import (auto_continuation, custom_basis,
                                    symbolic_export)

RTOL = 1e-13
x, y = symbols('x y')
n = symbols('n', positive=True)


@pytest.fixture(scope="module")
def jax_export():
    """The JAX package's export of the RP symbolic configuration with k_d
    free: python, Fortran and the AUTO-07p pair."""
    pars = symbolic_export.params(JaxQgParams)
    kd = pars.atmospheric_params.kd
    python_code, eq = jax_sym.create_symbolic_tendencies(
        pars, continuation_variables=[kd], language='python',
        return_symbolic_eqs=True)
    auto_main, auto_conf = jax_sym.equation_as_function(eq, pars, [kd],
                                                        language='auto')
    return dict(pars=pars, python=python_code, auto_main=auto_main,
                auto_conf=auto_conf,
                fortran=jax_sym.equation_as_function(eq, pars, [kd],
                                                     language='fortran'))


class JaxWeightedIP(JaxDefinition):
    """The JAX script's weighted inner product."""

    weight = exp(-y / 2)

    @staticmethod
    def normalization(nv):
        return float(nv) / (2 * np.pi ** 2)

    def symbolic_inner_product(self, S, G, symbolic_expr=False,
                               integrand=False):
        expr = (n / (2 * pi ** 2)) * exp(-y / 2) * S * G
        if integrand:
            return expr, (x, 0, 2 * pi / n), (y, 0, pi)
        return self.integrate_over_domain(self.optimizer(expr),
                                          symbolic_expr=symbolic_expr)


def test_custom_basis():
    out = custom_basis.main(device="cpu", short=True, plot=False)
    basis = JaxBasis()
    for i in (1, 2):
        for j in (1, 2):
            basis.append(2 * sin(j * n * x / 2) * sin(i * y))
    basis.substitutions = [(n, 1.5)]
    pars = JaxQgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_modes(basis, auto=True)
    aip = JaxAtmSymbolic(pars, inner_product_definition=JaxWeightedIP(),
                         quadrature=True)
    np.testing.assert_array_equal(out["u"], np.asarray(aip._u))
    tensor = JaxQgsTensor(pars, aip, None, None)
    f_b, _ = jax_fns(tensor.tensor, tensor.jacobian_tensor)
    xs = np.random.default_rng(0).random((1, pars.ndim)) * 0.1
    ref = np.asarray(f_b(0., jnp.asarray(xs)))
    assert type(out["tendencies"]) is np.ndarray
    np.testing.assert_allclose(out["tendencies"], ref, rtol=RTOL,
                               atol=1e-16 * np.abs(ref).max())


def test_symbolic_export(jax_export, tmp_path):
    out = symbolic_export.main(device="cpu", short=True, plot=False,
                               outdir=str(tmp_path))
    for key in ("python", "fortran", "auto_main", "auto_conf"):
        assert out[key] == jax_export[key], key
    for fname, key in (("qgs_model.f90", "fortran"),
                       ("qgs_auto.f90", "auto_main"),
                       ("c.qgs_auto", "auto_conf")):
        assert (tmp_path / fname).read_text() == jax_export[key]


def test_auto_continuation(jax_export, tmp_path):
    out = auto_continuation.main(device="cpu", short=True, plot=False,
                                 outdir=str(tmp_path))
    assert out["auto_main"] == jax_export["auto_main"]
    assert out["auto_conf"] == jax_export["auto_conf"]
    assert (tmp_path / "c.qgs_auto").read_text() == jax_export["auto_conf"]
    f_num, _ = jax_tendencies(jax_export["pars"])
    x0 = np.random.default_rng(0).random(jax_export["pars"].ndim) * 0.1
    ref = np.asarray(f_num(0.0, x0))
    assert type(out["fx_num"]) is np.ndarray
    np.testing.assert_allclose(out["fx_num"], ref, rtol=RTOL,
                               atol=1e-16 * np.abs(ref).max())
    assert out["err"] < auto_continuation.BOUND
