"""The rank-5 RK4 step's share of its roofline: the least time the card
could take for the traced calls' RK4 steps of the quartic tendency
(``work.rk4_work``: operations at vector float64, 34 TFLOP/s, or bytes at
3.35 TB/s), over the device's busy time in the trace.  The work is the
model's, whatever implements the step (today the plain step loop over the
two-level contraction of ``ops/contraction.py``), so that another
implementation is read on the same yardstick."""

UNIT = "%"


def read(r):
    bound = getattr(r.job, "rk4_bound_s", None)
    t = r.trace
    if bound is None or t is None or not t["busy_s"] > 0:
        return None
    return 100.0 * bound * r.calls / t["busy_s"]
