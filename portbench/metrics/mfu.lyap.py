"""The Benettin window's share of the card's peak: the operations the
traced calls need (the state's RK4, the tangent block's, the Householder
QR) over the traced window at 67 TFLOP/s, the card's highest float64
rate (device trace)."""

from portbench.harness import readers

UNIT = "%"


def read(r):
    return readers.mfu(r)
