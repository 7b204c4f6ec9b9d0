"""Device operations (kernels, copies, sets) a data-assimilation cycle:
those in the trace over the traced cycles."""

from portbench.harness import readers

UNIT = "launches/cycle"


def read(r):
    return readers.device_events_per(r, r.calls)
