"""Milliseconds a call outside the fused RK4 kernel: the traced window
less the kernel's device time, over the traced calls (device trace)."""

from portbench.harness import readers
from portbench.harness import trace as tracing

UNIT = "ms"


def read(r):
    if r.trace is None or r.calls == 0:
        return None
    kernel = (tracing.device_seconds(r.trace, readers.K1_RESIDENT)
              + tracing.device_seconds(r.trace, readers.K1_STREAMED))
    if kernel <= 0:
        return None
    return 1e3 * (r.trace["window_s"] - kernel) / r.calls
