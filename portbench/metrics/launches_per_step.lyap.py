"""Device operations (kernels, copies, sets) a Benettin window, over all
the members: those in the trace over the traced windows."""

from portbench.harness import readers

UNIT = "launches/step"


def read(r):
    return readers.device_events_per(r, r.calls * r.job.windows_per_call)
