"""Seconds to build (on a checkout's first run) or load the port's
kernel library, qgs_tpu_torch.ops._build.load_library (host clock)."""

UNIT = "s"


def read(r):
    return r.timers["library_s"] if "library_s" in r.timers else None
