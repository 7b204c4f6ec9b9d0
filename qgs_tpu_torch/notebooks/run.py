"""
Notebook runner
===============

Executes the port's notebooks in place through ``nbclient`` (the
counterpart of the JAX package's ``tools/run_notebooks.py``).  Each
notebook's parameters (the markdown note and the code cell tagged
``parameters``) are set first, from
:func:`qgs_tpu_torch.notebooks.make.parameter_cells`, so a notebook states
the device and the lengths it was executed with.  The kernel's working
directory is this directory, so the first code cell's ``sys.path`` entry
reaches the repository root.

Run as ``python -m qgs_tpu_torch.notebooks.run [--device cpu|cuda]
[--full] [names]``: the device is ``cuda`` unless told otherwise, the
lengths are ``short=True`` unless ``--full``; with no names every notebook
of the catalog runs.
"""

from __future__ import annotations

import argparse
import sys
import time

from qgs_tpu_torch.notebooks import make


def set_parameters(nb, values):
    """Replace the notebook's parameter cells (tagged ``parameters``) by
    those :func:`~qgs_tpu_torch.notebooks.make.parameter_cells` gives for
    ``values`` (each name the cell binds, given or kept)."""
    import ast

    import nbformat

    at = [i for i, c in enumerate(nb.cells)
          if "parameters" in c.get("metadata", {}).get("tags", [])]
    if len(at) != 2:
        raise ValueError("a notebook has one markdown and one code cell "
                         "tagged 'parameters'")
    current = {}
    for stmt in ast.parse(nb.cells[at[1]].source).body:
        current[stmt.targets[0].id] = ast.literal_eval(stmt.value)
    current.update({k: v for k, v in values.items() if k in current})
    for i, cell in zip(at, make.parameter_cells(current)):
        nb.cells[i] = nbformat.from_dict(dict(cell, id=nb.cells[i].id))
    return current


def run_one(path, values, timeout=2400):
    """Set the parameters of the notebook at ``path`` and execute it in
    place; returns the seconds it took."""
    import nbformat
    from nbclient import NotebookClient

    nb = nbformat.read(path, as_version=4)
    set_parameters(nb, values)
    client = NotebookClient(nb, timeout=timeout, kernel_name="python3",
                            resources={"metadata": {"path": str(make.HERE)}})
    t0 = time.perf_counter()
    client.execute()
    nbformat.write(nb, path)
    return time.perf_counter() - t0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--full", action="store_true",
                        help="the examples' full lengths")
    parser.add_argument("names", nargs="*",
                        help="notebook file names (default: all)")
    args = parser.parse_args(argv)
    names = args.names or [*make.CATALOG.values(), make.INTRO]
    values = dict(device=args.device, short=not args.full)
    failures = []
    for name in names:
        try:
            secs = run_one(make.HERE / name, values)
            print(f"{name}: executed in {secs:.0f} s on {args.device}",
                  flush=True)
        except Exception as err:                   # report, run the rest
            failures.append(name)
            print(f"{name}: FAILED: {str(err)[:500]}", flush=True)
    if failures:
        sys.exit(f"{len(failures)} notebook(s) failed: "
                 + ", ".join(failures))


if __name__ == "__main__":
    main()
