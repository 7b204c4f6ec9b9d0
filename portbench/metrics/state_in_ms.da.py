"""Milliseconds a data-assimilation cycle of the port's span
``qgs.state_in``: the NumPy analysis to a device tensor, and the time
grid's upload, summed over the traced cycles (``span_totals``); left out
where no traced cycle launched a kernel."""

UNIT = "ms"


def read(r):
    from qgs_tpu_torch.utils import profiling
    totals = getattr(profiling, "span_totals", lambda: {})()
    if (r.trace is None or r.calls == 0 or "qgs.layout" not in totals
            or "qgs.state_in" not in totals):
        return None
    return 1e3 * totals["qgs.state_in"][1] / r.calls
