"""Seconds from the process's start to the port imported: Python's and
torch's imports, CUDA's initialisation and the port's modules (host
clock)."""

UNIT = "s"


def read(r):
    return sum(r.timers.get(k, 0.0) for k in ("torch_s", "cuda_s",
                                               "imports_s"))
