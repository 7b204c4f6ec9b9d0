"""Seconds from the process's start to the first timed call: imports,
the kernel library (built on a checkout's first run), the tendencies, the
inputs and the warm-up call (host clock)."""

UNIT = "s"


def read(r):
    return r.setup_s
