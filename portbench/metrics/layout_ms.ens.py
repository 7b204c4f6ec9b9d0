"""Milliseconds a call of the host's kernel layout: the port's spans
``qgs.route`` (the kernel's choice), ``qgs.layout`` (the tables built)
and ``qgs.layout_in`` (their uploads), summed over the traced calls
(``qgs_tpu_torch.utils.profiling.span_totals``; the spans record only
under the profiler, so the totals are the traced window's)."""

UNIT = "ms"
SPANS = ("qgs.route", "qgs.layout", "qgs.layout_in")


def read(r):
    from qgs_tpu_torch.utils import profiling
    totals = getattr(profiling, "span_totals", lambda: {})()
    if r.trace is None or r.calls == 0 or "qgs.layout" not in totals:
        return None
    return 1e3 * sum(totals[s][1] for s in SPANS if s in totals) / r.calls
