"""
Host setup layers
=================

The parameters, inner products, tendency tensors (rank 3, dynamic-T and
T4, and their atmospheric thermodynamic parts) and COO container: the
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
from qgs_tpu_torch.tensors.atmo_thermo import (
    AtmoThermoTensor, AtmoThermoTensorDynamicT, AtmoThermoTensorT4,
)
from qgs_tpu_torch.tensors.qgtensor import (QgsTensor, QgsTensorDynamicT,
                                            QgsTensorT4)
from qgs_tpu_torch.utils.sparse import COO

__all__ = [
    "QgParams",
    "AtmosphericAnalyticInnerProducts", "OceanicAnalyticInnerProducts",
    "GroundAnalyticInnerProducts",
    "AtmosphericSymbolicInnerProducts", "OceanicSymbolicInnerProducts",
    "GroundSymbolicInnerProducts",
    "QgsTensor", "QgsTensorDynamicT", "QgsTensorT4",
    "AtmoThermoTensor", "AtmoThermoTensorDynamicT", "AtmoThermoTensorT4",
    "COO",
]
