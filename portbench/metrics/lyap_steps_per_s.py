"""Member-windows completed a second: every member times every Benettin
window (one TGLS RK4 step and one QR) of the calls completed in the
window, over the window (host clock)."""

from portbench.harness import readers

UNIT = "member-steps/s"


def read(r):
    return readers.rate(r)
