"""
qgs-tpu-torch: the PyTorch/CUDA port of qgs-tpu
===============================================

A second implementation of qgs-tpu in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.  Module paths mirror ``qgs_tpu/`` so that each
module's counterpart is easy to find.  The host setup layers (parameters,
basis, inner products, tendency tensor; NumPy/SymPy) are the package's own
copies, under the JAX package's module paths.  Nothing in this package
imports JAX or the JAX package.

Modules that build tensors put them on ``device="cuda"`` unless the caller
passes another device (``device="cpu"`` for the CPU).
"""

__version__ = "0.1.0"
