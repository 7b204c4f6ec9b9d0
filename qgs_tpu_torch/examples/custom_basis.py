"""A user-defined symbolic basis and a custom (weighted) inner product,
the framework's extensibility path (counterpart of
``examples/custom_basis.py``)."""

import numpy as np
from sympy import exp, pi, sin, symbols

from qgs_tpu_torch.basis.base import SymbolicBasis
from qgs_tpu_torch.examples import F64, cli
from qgs_tpu_torch.inner_products.definition import (
    StandardSymbolicInnerProductDefinition)
from qgs_tpu_torch.inner_products.symbolic import (
    AtmosphericSymbolicInnerProducts)
from qgs_tpu_torch.ops.contraction import make_tendency_fns
from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.tensors.qgtensor import QgsTensor

x, y = symbols('x y')
n = symbols('n', positive=True)
TOLERANCES = {"u": F64, "tendencies": F64}


class ExponentiallyWeightedIP(StandardSymbolicInnerProductDefinition):
    """Inner product weighted by exp(-y/2) (the user-guide example): the
    quadrature engine reads ``weight`` and ``normalization``, the exact
    SymPy engine calls ``symbolic_inner_product``."""

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


def basis():
    """A hand-rolled basis: any list of SymPy expressions in (x, y) that
    meets the boundary conditions works; substitutions pin free symbols
    (here the aspect ratio n)."""
    b = SymbolicBasis()
    for i in (1, 2):
        for j in (1, 2):
            b.append(2 * sin(j * n * x / 2) * sin(i * y))
    b.substitutions = [(n, 1.5)]
    return b


def main(device="cuda", short=False, plot=True, outdir="."):
    # nothing is drawn and no length to cut: the common call's arguments
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_modes(basis(), auto=True)

    # With a non-trivial weight the mass matrix u is no longer the
    # identity, and the mass-matrix inversions of the tensor assembly
    # matter.
    aip = AtmosphericSymbolicInnerProducts(
        pars, inner_product_definition=ExponentiallyWeightedIP(),
        quadrature=True)
    u = np.asarray(aip._u)
    print("custom-weighted mass matrix u (no longer the identity):")
    print(np.array2string(u, precision=4, suppress_small=True))

    # The tensor is assembled on the host and laid out on the device; the
    # batched tendency takes the NumPy states as they are and returns NumPy.
    tensor = QgsTensor(pars, aip, None, None)
    f_b, _ = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor,
                               device=device)
    xs = np.random.default_rng(0).random((1, pars.ndim)) * 0.1
    tend = f_b(0., xs)
    print("tendencies at a random state:", tend[0][:4], "...")
    return dict(u=u, tendencies=tend)


if __name__ == "__main__":
    cli(main)
