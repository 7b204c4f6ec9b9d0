"""The resident fused RK4 kernel's (csrc/rk4_fused.cu) share of its
roofline: the least time the card could take for its operations (vector
float64, 34 TFLOP/s) or bytes (3.35 TB/s), over its device time in the
trace."""

from portbench.harness import readers

UNIT = "%"


def read(r):
    return readers.kernel_roofline(r, readers.K1_RESIDENT)
