"""Milliseconds a data-assimilation cycle of the host's kernel layout:
``layout_ms.ens``'s reading (the spans ``qgs.route``, ``qgs.layout`` and
``qgs.layout_in`` over the traced calls) in the cell whose call is a
cycle."""

import pathlib

from portbench.harness import loader

UNIT = "ms"


def read(r):
    return loader.metric("layout_ms.ens",
                         pathlib.Path(__file__).parents[1]).read(r)
