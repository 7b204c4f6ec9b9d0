"""The device's idle share of the traced window: 1 less the union of
its operations over the window (device trace)."""

from portbench.harness import readers

UNIT = "%"


def read(r):
    return readers.idle_share(r)
