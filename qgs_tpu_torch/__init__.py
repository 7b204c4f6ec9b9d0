"""
qgs-tpu-torch: the PyTorch/CUDA port of qgs-tpu
===============================================

A second implementation of the qgs-tpu device compute path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.  Module paths mirror
``qgs_tpu/`` so that each module's counterpart is easy to find.  The host
setup layers (parameters, basis, inner products, tendency tensor) are the
JAX package's own NumPy/SymPy code, imported through
:mod:`qgs_tpu_torch.host`; nothing in this package imports JAX.

Importing ``qgs_tpu`` runs ``import jax`` unless ``QGS_TPU_X64=0`` is set
(``qgs_tpu/__init__.py``).  Where JAX is not installed, this package sets
that variable before anything touches ``qgs_tpu``; where JAX is installed
(the parity tests run both packages in one process) the environment is left
alone, so the JAX reference keeps float64.
"""

import importlib.util
import os

if importlib.util.find_spec("jax") is None:
    os.environ.setdefault("QGS_TPU_X64", "0")

__version__ = "0.1.0"
