"""Seconds of the host set-up: the configuration's QgParams and
create_tendencies (basis, inner products, tensor, the tendency modules on
the device; host clock)."""

UNIT = "s"


def read(r):
    return r.timers["tendencies_s"]
