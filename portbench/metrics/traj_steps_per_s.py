"""Trajectory-steps completed a second: every member times every RK4
step of the calls completed in the window, over the window (host clock)."""

from portbench.harness import readers

UNIT = "traj-steps/s"


def read(r):
    return readers.rate(r)
