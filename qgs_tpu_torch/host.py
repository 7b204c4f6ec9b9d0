"""
Host setup layers
=================

The parameters, inner products, tendency tensor and COO container are the
JAX package's own NumPy/SymPy code, re-exported here unchanged.  Import them
from this module (and not from ``qgs_tpu`` directly) so that the package's
JAX-absent guard in :mod:`qgs_tpu_torch` has run first.
"""

from qgs_tpu.params.params import QgParams
from qgs_tpu.inner_products.analytic import (
    AtmosphericAnalyticInnerProducts, GroundAnalyticInnerProducts,
    OceanicAnalyticInnerProducts,
)
from qgs_tpu.inner_products.symbolic import (
    AtmosphericSymbolicInnerProducts, GroundSymbolicInnerProducts,
    OceanicSymbolicInnerProducts,
)
from qgs_tpu.tensors.qgtensor import QgsTensor
from qgs_tpu.utils.sparse import COO

__all__ = [
    "QgParams",
    "AtmosphericAnalyticInnerProducts", "OceanicAnalyticInnerProducts",
    "GroundAnalyticInnerProducts",
    "AtmosphericSymbolicInnerProducts", "OceanicSymbolicInnerProducts",
    "GroundSymbolicInnerProducts",
    "QgsTensor", "COO",
]
