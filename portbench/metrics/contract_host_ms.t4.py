"""Milliseconds a call that the host spends in the port's span
``qgs.two_level``: each evaluation of a two-level (rank-5) contraction,
its gathers, products and sums dispatched, summed over the traced calls
(``qgs_tpu_torch.utils.profiling.span_totals``; the span records only
under the profiler).  Left out on a port without the span."""

UNIT = "ms"


def read(r):
    from qgs_tpu_torch.utils import profiling
    totals = getattr(profiling, "span_totals", lambda: {})()
    if r.trace is None or r.calls == 0 or "qgs.two_level" not in totals:
        return None
    return 1e3 * totals["qgs.two_level"][1] / r.calls
