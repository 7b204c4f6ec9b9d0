"""Arithmetic that several metric readers share.  A reader returns None
where it finds nothing to read, and the metric is then left out of the
result line."""

from portbench.harness import trace as tracing
from portbench.harness import work

# kernel names of the port's fused RK4 kernels in a device trace
K1_RESIDENT = "rk4_fused_kernel"
K1_STREAMED = "rk4_streamed_kernel"


def rate(r):
    """Work units over the window's seconds (untraced runs only)."""
    if r.trace is not None or not r.window_s > 0:
        return None
    return r.units / r.window_s


def idle_share(r):
    """The device's idle share of the traced window, in %."""
    t = r.trace
    if t is None or not t["window_s"] > 0 or t["device_events"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(r):
    """The operations the traced calls need over the traced window at the
    card's highest float64 rate, in %."""
    t = r.trace
    if t is None or not t["window_s"] > 0 or t["device_events"] == 0:
        return None
    return 100.0 * r.job.ops_per_call * r.calls / (t["window_s"]
                                                   * work.PEAK_F64)


def kernel_roofline(r, fragment):
    """The kernel's bound over its device time in the trace, in %."""
    if r.trace is None:
        return None
    seconds = tracing.device_seconds(r.trace, fragment)
    if seconds <= 0:
        return None
    return 100.0 * r.job.k1_bound_s * r.calls / seconds


def device_events_per(r, units):
    """Device operations (kernels, copies, sets) in the trace over
    ``units``."""
    if r.trace is None or r.trace["device_events"] == 0 or units <= 0:
        return None
    return r.trace["device_events"] / units
