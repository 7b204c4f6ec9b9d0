#!/usr/bin/env python3
"""The control of a cell's comparison: a run of the cell with the plain
reference, computed one precision below the configuration's (float32 for
float64), in the program's place, at the cell's own sizes.  Its numbers
are the upper readings the cell's limits are set below, and its
``correct`` has to come out false.

    python3 portbench/control.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on the card (``--device cpu`` for a trial on
the CPU).  The benchmark's own runs never run it.  It prints the run's
lines and, last, the result line as ``run.py`` does."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

# a configuration's precision -> the control's, the next below it
LOWER = {"float64": "float32"}


def stand_in(job, ctx):
    """``edit_job`` of the control: the stand-in of the reference in the
    precision below the configuration's takes the program's place, and the
    frozen tensor rounded to it the set-up's."""
    import numpy as np
    import torch

    from portbench.reference import stand_in as si

    name = LOWER[ctx.config["precision"]]
    dtype = getattr(torch, name)
    ctx.tensor = (ctx.frozen.coords, ctx.frozen.data.astype(np.dtype(name)))
    if hasattr(job, "integrator"):
        job.integrator = si.Integrator(ctx.frozen, dtype, ctx.device)
    if hasattr(job, "estimator"):
        job.estimator = si.Estimator(ctx.frozen, dtype, "cpu")


def no_launches(cell):
    cell["workload"]["expect_launches"] = {
        k: 0 for k in cell["workload"]["expect_launches"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import runner

    result = runner.run(args.workload, args.seed, args.seconds, False,
                        t_start=T_START, device=args.device, edit=no_launches,
                        edit_job=stand_in,
                        say=lambda line: print(line, flush=True))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
