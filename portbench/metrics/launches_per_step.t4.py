"""Device operations (kernels, copies, sets) an RK4 step of the quartic
ensemble: those in the trace over the traced calls' steps."""

from portbench.harness import readers

UNIT = "launches/step"


def read(r):
    steps = getattr(r.job, "steps_per_call", None)
    if steps is None:
        return None
    return readers.device_events_per(r, r.calls * steps)
