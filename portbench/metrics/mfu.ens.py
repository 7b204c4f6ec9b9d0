"""The ensemble step's share of the card's peak: the operations the
traced calls need (4 tendency evaluations and the combine a
trajectory-step) over the traced window at 67 TFLOP/s, the card's highest
float64 rate (device trace)."""

from portbench.harness import readers

UNIT = "%"


def read(r):
    return readers.mfu(r)
