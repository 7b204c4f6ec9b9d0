"""A configuration file's ``qgparams`` block applied to a ``QgParams``.

The block is a list of calls, ``[method, args]``, each ``method`` a dotted
attribute path on the parameters object whose last part starts with
``set_``.  The class is passed in, so that the same block builds the
port's parameters (at run time) and any other package's (when a frozen
reference tensor is made)."""

from __future__ import annotations


def build_params(qgparams_cls, block):
    """A new ``qgparams_cls()`` with the block's calls applied in order."""
    pars = qgparams_cls()
    for method, args in block["calls"]:
        *owners, name = method.split(".")
        if not name.startswith("set_"):
            raise ValueError(f"configuration call {method!r}: only set_* "
                             "methods are applied")
        target = pars
        for owner in owners:
            target = getattr(target, owner)
        getattr(target, name)(*args)
    return pars
