"""The check that the process never loaded JAX or the JAX package.

Module names are compared by their top-level name (the part before the
first dot) as a whole, so ``qgs_tpu_torch`` is not ``qgs_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "qgs_tpu")


def forbidden_modules(names=None):
    """The loaded modules (``sys.modules`` by default) whose top-level name
    is one of :data:`FORBIDDEN`, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
