"""Milliseconds a data-assimilation cycle: the window over the cycles
completed in it (host clock), each from the analysis handed over as
NumPy to the forecast back on the host as NumPy."""

UNIT = "ms"


def read(r):
    if r.trace is not None or r.calls == 0:
        return None
    return 1e3 * r.window_s / r.calls
