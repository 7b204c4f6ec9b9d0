"""Reference-import-path shim: the reference exposes the tendencies
factory as ``qgs.functions.tendencies`` (ref
``qgs/functions/tendencies.py:20-211``); in the port the implementation
lives in :mod:`qgs_tpu_torch.models.tendencies` (tensors on ``device="cuda"``
unless the caller asks for another device).  This module re-exports it so
reference code ports with only the package rename."""

from qgs_tpu_torch.models.tendencies import (          # noqa: F401
    create_tendencies, create_atmo_thermo_tendencies,
)
