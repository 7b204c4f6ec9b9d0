"""The share of the device's idle time, in the traced data-assimilation
cycles, that the trace's summary names after one of the port's ``qgs.``
spans (each idle gap takes the name of the host operation that overlaps
it most), in %.  The rest is the job's own host work (records to NumPy,
the next analysis) and whatever the spans leave out."""

UNIT = "%"


def read(r):
    from qgs_tpu_torch.utils import profiling
    totals = getattr(profiling, "span_totals", lambda: {})()
    if r.trace is None or "qgs.layout" not in totals:
        return None
    idle = sum(seconds for seconds, _ in r.trace["gaps"])
    if not idle > 0:
        return None
    return 100.0 * sum(seconds for seconds, name in r.trace["gaps"]
                       if name.startswith("qgs.")) / idle
