"""Two-level (rank-5) contractions evaluated a step of the plain step
loop: the port's counters ``contraction.two_level_calls`` over
``rk.plain_steps``, both since the process started (4.0 on the plain RK4
path).  Left out where no plain step ran, and on a port without the
counters; read in a traced run."""

UNIT = "evals/step"


def read(r):
    from qgs_tpu_torch.integrators import rk
    from qgs_tpu_torch.ops import contraction
    evals = getattr(contraction, "two_level_calls", None)
    steps = getattr(rk, "plain_steps", None)
    if r.trace is None or evals is None or not steps:
        return None
    return evals / steps
