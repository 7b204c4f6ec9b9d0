"""
Drop-in ``qgs`` import compatibility, on the port
=================================================

Importing this module installs the ``qgs`` package namespace as an alias
of :mod:`qgs_tpu_torch`, so a script written against the reference
framework (ref ``qgs/__init__.py`` and the module tree under ``qgs/``)
runs unchanged on the CUDA card::

    import qgs_tpu_torch.compat      # one line added at the top
    from qgs.params.params import QgParams
    from qgs.functions.tendencies import create_tendencies
    from qgs.integrators.integrator import RungeKuttaIntegrator

``create_tendencies`` builds its tensors on ``device="cuda"`` unless the
caller asks for another device, so ``RungeKuttaIntegrator().integrate``
runs the fused RK4 kernels on the card.  Every reference module path is
covered; the only renames are mapped explicitly below
(``qgs.tensors.atmo_thermo_tensor``, and the Numba kernels of
``qgs.functions.sparse_mul``, whose reference-semantics NumPy equivalents
live in :mod:`qgs_tpu_torch.models.numpy_backend`).

The aliases are installed lazily through an
:class:`importlib.abc.MetaPathFinder`, so importing this module imports no
other module of the port, and ``qgs.X`` is the port's module object
itself (``sys.modules["qgs.X"] is sys.modules["qgs_tpu_torch.X"]``).

The alias is process-wide.  :func:`install` raises ``ImportError`` when a
``qgs`` alias of another package (such as the JAX package's ``compat``) is
already installed, or when ``sys.modules`` already holds ``qgs`` modules
from elsewhere, since either would serve that package's modules under the
same names.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import sys

PACKAGE = "qgs_tpu_torch"

#: explicit renames (reference path -> port path); every other ``qgs.X``
#: maps to ``qgs_tpu_torch.X`` one-to-one.
_SPECIAL = {
    "qgs.tensors.atmo_thermo_tensor": "qgs_tpu_torch.tensors.atmo_thermo",
    "qgs.functions.sparse_mul": "qgs_tpu_torch.models.numpy_backend",
}


def _target(fullname: str) -> str:
    if fullname in _SPECIAL:
        return _SPECIAL[fullname]
    return PACKAGE + fullname[len("qgs"):]


class _QgsAliasLoader(importlib.abc.Loader):
    def create_module(self, spec):
        module = importlib.import_module(_target(spec.name))
        sys.modules[spec.name] = module
        return module

    def exec_module(self, module):  # already executed by the real import
        pass


class _QgsAliasFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname != "qgs" and not fullname.startswith("qgs."):
            return None
        try:
            real = importlib.util.find_spec(_target(fullname))
        except ModuleNotFoundError:
            return None
        if real is None:
            return None
        spec = importlib.util.spec_from_loader(fullname, _QgsAliasLoader())
        spec.submodule_search_locations = real.submodule_search_locations
        return spec


def _is_qgs(name):
    return name == "qgs" or name.startswith("qgs.")


def install():
    """Install the ``qgs`` alias finder (idempotent).

    Raises ``ImportError`` when another package's ``qgs`` alias finder is
    on ``sys.meta_path`` (told apart by its class's module, which is not
    imported here), or when ``sys.modules`` holds a ``qgs`` module that is
    not one of the port's."""
    if any(isinstance(f, _QgsAliasFinder) for f in sys.meta_path):
        return
    others = [type(f).__module__ for f in sys.meta_path
              if type(f).__name__ == "_QgsAliasFinder"
              and type(f).__module__ != __name__]
    if others:
        raise ImportError(
            f"a qgs alias of another package is installed ({others[0]}); "
            "the port's alias cannot share the process with it")
    foreign = sorted(name for name, mod in list(sys.modules.items())
                     if _is_qgs(name) and mod is not None
                     and not getattr(mod, "__name__", "").startswith(
                         PACKAGE))
    if foreign:
        raise ImportError(
            f"sys.modules already holds qgs modules from another package "
            f"({', '.join(foreign[:3])}{', ...' if len(foreign) > 3 else ''}"
            "); the port's alias cannot share the process with them")
    # first, not last: the path finder would otherwise find each submodule
    # of ``qgs`` in the aliased package's ``__path__`` and load a second
    # copy of it under the ``qgs.`` name
    sys.meta_path.insert(0, _QgsAliasFinder())


install()
