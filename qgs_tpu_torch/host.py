"""
Host setup layers
=================

The parameters, inner products, tendency tensor and COO container: the
port's own copies of the JAX package's NumPy/SymPy modules, under the same
paths (``qgs_tpu_torch.params``, ``.basis``, ``.inner_products``,
``.tensors``, ``.utils``), re-exported here for the port's call sites.
"""

from qgs_tpu_torch.params.params import QgParams
from qgs_tpu_torch.inner_products.analytic import (
    AtmosphericAnalyticInnerProducts, GroundAnalyticInnerProducts,
    OceanicAnalyticInnerProducts,
)
from qgs_tpu_torch.inner_products.symbolic import (
    AtmosphericSymbolicInnerProducts, GroundSymbolicInnerProducts,
    OceanicSymbolicInnerProducts,
)
from qgs_tpu_torch.tensors.qgtensor import QgsTensor
from qgs_tpu_torch.utils.sparse import COO

__all__ = [
    "QgParams",
    "AtmosphericAnalyticInnerProducts", "OceanicAnalyticInnerProducts",
    "GroundAnalyticInnerProducts",
    "AtmosphericSymbolicInnerProducts", "OceanicSymbolicInnerProducts",
    "GroundSymbolicInnerProducts",
    "QgsTensor", "COO",
]
