"""
Notebook generator
==================

Writes the port's notebooks from :mod:`qgs_tpu_torch.examples` (the
counterpart of the JAX package's ``tools/make_notebooks.py`` and
``tools/make_intro_notebook.py``).  For each example module:

1. a title cell, the module docstring;
2. a code cell that puts the repository root on ``sys.path`` (the
   notebooks run from this directory);
3. a setup cell: the module's imports, constants and functions (its
   ``params()`` among them), everything above ``main``;
4. the parameters: a markdown cell saying how the notebook runs, then a
   code cell binding ``device``, ``short``, ``plot`` and ``outdir`` (and
   any further argument of ``main``) explicitly;
5. the body of ``main``, split into cells at its blank lines, each leading
   comment becoming a markdown cell; a figure saved with ``savefig`` is
   shown with :func:`qgs_tpu_torch.notebooks.show`, and the ``return``
   becomes the last cell's displayed ``result``.

Run as ``python -m qgs_tpu_torch.notebooks.make [--force]``: notebooks that
carry outputs are not overwritten unless ``--force`` is given (execute
them again with :mod:`qgs_tpu_torch.notebooks.run` afterwards).
"""

from __future__ import annotations

import ast
import json
import pathlib
import sys
import textwrap

from qgs_tpu_torch.examples import NAMES

HERE = pathlib.Path(__file__).resolve().parent
EXAMPLES = HERE.parent / "examples"

# example module -> notebook, under the JAX package's notebook names
# (tools/make_notebooks.py CATALOG)
CATALOG = {
    "rp_atmosphere": "simple_run.ipynb",
    "maooam_coupled": "maooam_run.ipynb",
    "ground_coupled": "maosoam_run.ipynb",
    "precision_tiers": "precision_tiers.ipynb",
    "external_solvers": "external_solvers.ipynb",
    "lyapunov_exponents": "model_lyapunov.ipynb",
    "clv_walkthrough": "clv_walkthrough.ipynb",
    "ensemble_statistics": "ensemble_statistics.ipynb",
    "distributed_ensembles": "distributed_ensembles.ipynb",
    "dynamic_temperature": "maooam_dynamic_temperature.ipynb",
    "t4_radiation": "maooam_T4.ipynb",
    "diagnostics_tour": "diagnostics.ipynb",
    "kernel_selection": "kernel_selection.ipynb",
    "custom_basis": "manual_basis_setting.ipynb",
    "symbolic_export": "symbolic_output.ipynb",
    "auto_continuation": "auto_continuation.ipynb",
}
INTRO = "introduction_qgs_tpu_torch.ipynb"
assert tuple(CATALOG) == NAMES

# the parameters every notebook binds, with the values a generated
# (unexecuted) notebook carries
DEFAULTS = dict(device="cuda", short=False, plot=True, outdir="outputs")
SHIM = 'import sys\n\nsys.path.insert(0, "../..")'


def markdown(text):
    return {"cell_type": "markdown", "metadata": {}, "source": text}


def code(text, **metadata):
    return {"cell_type": "code", "execution_count": None,
            "metadata": metadata, "outputs": [], "source": text}


def parameter_cells(values):
    """The markdown note and the code cell of a notebook's parameters
    (both tagged ``parameters``), for ``values`` (an ordered dict of the
    parameter names and their values)."""
    device, short = values["device"], values["short"]
    where = ("the CPU" if device == "cpu" else f"the CUDA card `{device}`")
    lengths = ("the shortened lengths of `short=True` (transients, windows "
               "and records cut; the configurations' widths kept)" if short
               else "the full lengths")
    note = (f"**Parameters.** This notebook runs on {where} "
            f"(`device={device!r}`), at {lengths}.  The cell below sets "
            "them; `python -m qgs_tpu_torch.notebooks.run --device cpu` "
            "executes it on the CPU, `--device cuda` on the card, `--full` "
            "at full lengths.")
    lines = [f"{k} = {v!r}" for k, v in values.items()]
    return [markdown(note) | {"metadata": {"tags": ["parameters"]}},
            code("\n".join(lines), tags=["parameters"])]


def _segment(src, node):
    return "\n".join(src.splitlines()[node.lineno - 1:node.end_lineno])


def _body_cells(body):
    """``main``'s dedented body as cells: split at blank lines followed by
    a line at column 0; a block's leading comment lines become a markdown
    cell."""
    blocks, cur = [], []
    lines = body.splitlines()
    for i, line in enumerate(lines):
        nxt = lines[i + 1] if i + 1 < len(lines) else ""
        if not line.strip() and nxt[:1] not in ("", " "):
            blocks.append(cur)
            cur = []
        else:
            cur.append(line)
    blocks.append(cur)
    cells = []
    for block in filter(None, blocks):
        n_c = 0
        while n_c < len(block) and block[n_c].startswith("#"):
            n_c += 1
        if n_c:
            text = " ".join(ln.lstrip("#").strip() for ln in block[:n_c])
            cells.append(markdown(text[:1].upper() + text[1:]))
        if block[n_c:]:
            cells.append(code("\n".join(block[n_c:])))
    return cells


def example_cells(name, values=None):
    """The cells of the notebook of the example module ``name``, its
    parameters cell binding ``values`` (default :data:`DEFAULTS`, and the
    defaults of ``main``'s further arguments)."""
    src = (EXAMPLES / f"{name}.py").read_text()
    tree = ast.parse(src)
    doc = ast.get_docstring(tree)
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    lines = src.splitlines()
    setup = "\n".join(lines[tree.body[0].end_lineno:main.lineno - 1]).strip()
    # main's own arguments, in order, with the generator's defaults
    args = [a.arg for a in main.args.args]
    own = dict(zip(args[len(args) - len(main.args.defaults):],
                   (ast.literal_eval(d) for d in main.args.defaults)))
    params = {k: (DEFAULTS[k] if k in DEFAULTS else own[k]) for k in args}
    params.update(values or {})
    ret = main.body[-1]
    if not isinstance(ret, ast.Return):
        raise ValueError(f"{name}.main does not end with its return")
    body = "\n".join(lines[main.body[0].lineno - 1:ret.lineno - 1])
    body = textwrap.dedent(body).rstrip()
    body = body.replace("savefig(plt, outdir,", "show(plt, outdir,")
    # ``return x`` -> ``result = x``, its continuation lines shifted along
    first, *more = textwrap.dedent(_segment(src, ret)).splitlines()
    result = "\n".join(["result = " + first[len("return "):],
                         *("  " + ln for ln in more)])
    title, _, rest = doc.partition("\n\n")
    cells = [markdown(f"# {' '.join(title.split())}\n\n{rest}".rstrip()
                      + f"\n\nGenerated from `qgs_tpu_torch/examples/"
                      f"{name}.py` by `python -m "
                      f"qgs_tpu_torch.notebooks.make`."),
             code(SHIM), markdown("**Setup**: the module's imports, "
                                  "constants and `params()`."),
             code(setup + "\n\n\nfrom qgs_tpu_torch.notebooks import show")]
    cells += parameter_cells(params)
    cells += _body_cells(body)
    cells.append(code(result + "\nresult"))
    return cells


INTRO_TEXT = """# Introduction to qgs_tpu_torch

`qgs_tpu_torch` is the PyTorch/CUDA port of `qgs_tpu`: the same models
(the two-layer channel atmosphere, the coupled MAOOAM ocean, the ground
and heat-exchange variants, dynamic-T and T^4 radiation), the same
parameters, diagnostics and Lyapunov toolbox, on one NVIDIA GPU.  The JAX
package stays the reference: every module of the port is held against it
on the CPU by `tests/test_torch_*.py`.  What differs for a user:

1. **`device=`.** Every entry point (`create_tendencies`, the
   integrators, the diagnostics, the toolbox, the examples) builds on
   `cuda` unless it is told otherwise; there is no silent fallback to the
   CPU.  A CPU run asks for it, `device="cpu"`, as every cell here does.
2. **`rng=`.** Random initial states come from an explicit NumPy
   generator, `integrator.initialize(..., rng=np.random.default_rng(seed))`:
   the port keeps no global seed.
3. **Three precision tiers.** float64 (Hopper's native f64), float32 (a
   `create_tendencies(..., dtype=torch.float32)` tendency) and twofloat
   (`RungeKuttaIntegrator(precision="twofloat")`, double-float pairs of
   float32 with error-free transformations, about 48 bits).
4. **Which path runs what.** On the card, classical RK4 of a rank-3
   tendency runs the whole integration in one launch of a fused kernel
   (the state stays on chip): K1 (`csrc/rk4_fused.cu`, float64 and
   float32) or K2 (`csrc/rk4_df_fused.cu`, twofloat), or their streamed
   counterparts for larger models.  Every other case runs plain torch
   ops: the CPU, other tableaux, the rank-5 (dynamic-T, T^4) models, the
   tangent-linear systems, and models past the streamed kernels' limit."""

SMEM_TEXT = """## The shared-memory rule

K1 and K2 hold the tendency tensor's whole layout (its entries in 8 row
groups, plus the state rows of a block of 32 trajectories) in one block's
shared memory.  Their streamed counterparts (`csrc/rk4_streamed.cu`,
`csrc/rk4_df_streamed.cu`) keep the entries in device memory, streamed
through a small ring, and only the two RK4 stage inputs in shared memory.
Before any launch the tendency's launch plan computes both needs with the
launchers' own formulas and compares them with the card's opt-in limit
(232,448 bytes a block on an H100): the resident kernel where it fits,
else the streamed one (`fused_rk4.launch_plan(...).kernel`, for K1's
family `fused_rk4.K1` and K2's `fused_df_rk4.DF`).  Only a
model past the streamed kernels' limit (on an H100 from ndim 422 in
float64 and twofloat, 844 in float32) takes the plain step loop on the
same card, as the JAX package's integrator does for every model.  For
MAOOAM at `QgParams`' defaults:

| Configuration | ndim | nnz | layout width | float64 | twofloat |
| --- | --- | --- | --- | --- | --- |
| 2x2/2x4 | 36 | 351 | 50 | K1 (43,776 B) | K2 (56,192 B) |
| 4x4/4x4 | 104 | 4,935 | 630 | K1 (187,648 B) | streamed K2 (70,144 B; K2 would need 254,592) |
| 6x6/6x6 | 228 | 27,811 | 3,506 | streamed K1 (133,632 B; K1 would need 682,752) | streamed K2 (133,632 B) |

The next cell computes the same decisions on the host (the limit passed
explicitly, so it needs no card)."""

INTRO_CELLS = [
    ("md", INTRO_TEXT),
    ("code", SHIM),
    ("code", """import numpy as np
import torch

from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.integrators.rk import fused_route, rk4_tableau
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops import fused_df_rk4, fused_rk4
from qgs_tpu_torch.params.params import QgParams


def maooam(atm=(2, 2), ocean=(2, 4)):
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(*atm)
    pars.set_oceanic_basin_fourier_modes(*ocean)
    return pars"""),
    ("params", None),
    ("md", "## 1. `device=`\n\nThe tendency is built where `device` says; "
           "its tensors and every state it returns live there."),
    ("code", """pars = maooam()
f, Df = create_tendencies(pars, device=device)
print(pars.ndim, f.batched.device, f.batched.dtype)"""),
    ("md", "## 2. `rng=`\n\n`initialize` draws its random states from the "
           "generator it is given; the same seed gives the same ensemble."),
    ("code", """integrator = RungeKuttaIntegrator()
integrator.set_func(f)
integrator.initialize(10. if short else 100., 0.1, number_of_trajectories=4,
                      rng=np.random.default_rng(0))
ic = integrator.get_ic()
again = RungeKuttaIntegrator()
again.set_func(f)
again.initialize(10. if short else 100., 0.1, number_of_trajectories=4,
                 rng=np.random.default_rng(0))
print(tuple(ic.shape), bool(torch.equal(torch.as_tensor(ic),
                                        torch.as_tensor(again.get_ic()))))"""),
    ("md", "## 3. Precision tiers\n\nThe same ensemble in float64, float32 "
           "and twofloat; the gaps against float64."),
    ("code", """span = 10. if short else 100.
runs = {}
for name, tendency, precision in (
        ("float64", f, "float64"),
        ("float32", create_tendencies(pars, dtype=torch.float32,
                                      device=device)[0], "float64"),
        ("twofloat", f, "twofloat")):
    integ = RungeKuttaIntegrator(precision=precision)
    integ.set_func(tendency)
    integ.integrate(0., span, 0.1, ic=ic, write_steps=0)
    runs[name] = integ.get_trajectories()[1].double().cpu()
for name, y in runs.items():
    print(f"{name}: max |y - y_float64| = "
          f"{float((y - runs['float64']).abs().max()):.3e}")"""),
    ("md", "## 4. Which path runs what\n\nEach kernel counts its launches "
           "(`fused_rk4.launches`, `fused_df_rk4.launches`); the plain "
           "step loop counts none.  On the CPU nothing is launched."),
    ("code", """fused_rk4.launches = fused_df_rk4.launches = 0
integ = RungeKuttaIntegrator()
integ.set_func(f)
integ.integrate(0., 1., 0.1, ic=ic)
y0 = torch.as_tensor(ic, device=device)
route = fused_route(f.batched, y0, rk4_tableau())
print("fused route:", route and route.name,
      "| launches K1", fused_rk4.launches, "K2", fused_df_rk4.launches)"""),
    ("md", SMEM_TEXT),
    ("code", """H100_OPTIN = 232448
for atm, ocean in (((2, 2), (2, 4)), ((4, 4), (4, 4)), ((6, 6), (6, 6))):
    fb = create_tendencies(maooam(atm, ocean), device="cpu")[0].batched
    n1 = fb.shape[0]
    width = fused_rk4.row_groups(fb.coords, n1, 8).width
    k1 = fused_rk4.smem_bytes(n1, 8, width, torch.float64)
    k2 = fused_df_rk4.df_smem_bytes(n1, 8, width)
    streamed = fused_rk4.streamed_smem_bytes(n1, 8, torch.float64)
    pick1 = fused_rk4.launch_plan(fb, fused_rk4.K1, torch.float64, "cuda",
                                  limit=H100_OPTIN).kernel
    pick2 = fused_rk4.launch_plan(fb, fused_df_rk4.DF, torch.float32, "cuda",
                                  limit=H100_OPTIN).kernel
    print(f"ndim {n1 - 1:3d}: nnz {len(fb.data):6d}, width {width:5d}, "
          f"K1 f64 {k1:7d} B, K2 {k2:7d} B, streamed {streamed:6d} B: "
          f"float64 {pick1}, twofloat {pick2}")"""),
]


def intro_cells(values=None):
    """The cells of the introduction notebook, its parameters cell binding
    ``values`` (default :data:`DEFAULTS`)."""
    params = dict(DEFAULTS)
    params.update(values or {})
    cells = []
    for kind, text in INTRO_CELLS:
        if kind == "params":
            cells += parameter_cells(params)
        else:
            cells.append(markdown(text) if kind == "md" else code(text))
    return cells


def cells_of(notebook_name, values=None):
    """The generated cells of the notebook ``notebook_name``, its
    parameters cell binding ``values``."""
    if notebook_name == INTRO:
        return intro_cells(values)
    name = {nb: mod for mod, nb in CATALOG.items()}[notebook_name]
    return example_cells(name, values)


def notebook(cells):
    """A notebook of ``cells``, each given the id of its position."""
    cells = [dict(c, id=f"cell-{i}") for i, c in enumerate(cells)]
    return {"cells": cells,
            "metadata": {"kernelspec": {"display_name": "Python 3",
                                        "language": "python",
                                        "name": "python3"},
                         "language_info": {"name": "python"}},
            "nbformat": 4, "nbformat_minor": 5}


def executed(path):
    """Whether the notebook at ``path`` carries outputs."""
    try:
        nb = json.loads(path.read_text())
    except (OSError, ValueError):
        return False
    return any(c.get("outputs") for c in nb.get("cells", [])
               if c.get("cell_type") == "code")


def write_all(force=False, out=HERE):
    """Write every notebook into ``out``; an executed one only with
    ``force``.  Returns the names written and the names skipped."""
    written, skipped = [], []
    for nb_name in [*CATALOG.values(), INTRO]:
        path = pathlib.Path(out) / nb_name
        if path.exists() and executed(path) and not force:
            skipped.append(nb_name)
            continue
        path.write_text(json.dumps(notebook(cells_of(nb_name)), indent=1)
                        + "\n")
        written.append(nb_name)
    return written, skipped


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    written, skipped = write_all(force="--force" in argv)
    for name in written:
        print(f"wrote {name}")
    if skipped:
        print(f"skipped {len(skipped)} executed notebook(s) (pass --force "
              f"to overwrite, then execute them again): "
              + ", ".join(skipped))


if __name__ == "__main__":
    main()
