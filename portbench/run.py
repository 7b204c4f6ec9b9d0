#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on this machine's cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``qgs_tpu_torch``).  The
cell's files are found by name under ``portbench/`` (see
``harness/loader.py``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared with its limit (also the last lines of standard error).

Exits with a code other than 0, and prints no result line, when there is
no CUDA card or fewer than the cell asks for, when the port cannot be
imported, and when the process loaded JAX or the JAX package."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _finite(obj):
    """The result with every number that is not finite written as 1e300:
    JSON has no infinity."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return 1e300
    return obj


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench.harness import guard, loader, runner

    chips = loader.workload(args.workload)["chips"]
    import torch
    marks = {"torch_s": time.perf_counter() - T_START}
    if not torch.cuda.is_available():
        print("portbench: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} cards, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    marks["cuda_s"] = time.perf_counter() - T_START - marks["torch_s"]
    result = runner.run(args.workload, args.seed, args.seconds,
                        bool(args.trace), t_start=T_START, marks=marks,
                        say=lambda line: print(line, flush=True))
    found = guard.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
