"""The port's committed notebooks (``qgs_tpu_torch/notebooks/``), the
counterpart of ``tests/test_notebooks_executed.py``: every notebook is
executed, is what ``qgs_tpu_torch.notebooks.make`` produces from its
example now (so none goes stale against ``qgs_tpu_torch/examples/``),
imports neither ``jax`` nor ``qgs_tpu``, and sets its device explicitly."""

import ast
import json
import pathlib

import pytest

from qgs_tpu_torch.notebooks import make

NB_DIR = pathlib.Path(make.__file__).resolve().parent
NOTEBOOKS = sorted(NB_DIR.glob("*.ipynb"))


def _source(cell):
    src = cell["source"]
    return "".join(src) if isinstance(src, list) else src


def _parameters(nb):
    """The values the notebook's parameters cell binds."""
    cells = [c for c in nb["cells"] if c["cell_type"] == "code"
             and "parameters" in c["metadata"].get("tags", [])]
    assert len(cells) == 1
    return {stmt.targets[0].id: ast.literal_eval(stmt.value)
            for stmt in ast.parse(_source(cells[0])).body}


def test_catalog_is_complete():
    assert len(NOTEBOOKS) >= 17
    assert {p.name for p in NOTEBOOKS} == {*make.CATALOG.values(),
                                           make.INTRO}


@pytest.mark.parametrize("path", NOTEBOOKS, ids=lambda p: p.name)
def test_notebook_is_executed(path):
    nb = json.loads(path.read_text())
    code = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert code, f"{path.name} has no code cells"
    assert any(c.get("outputs") for c in code), (
        f"{path.name} carries no outputs: run python -m "
        "qgs_tpu_torch.notebooks.run --device cpu")
    unrun = [i for i, c in enumerate(code) if c.get("execution_count") is None]
    assert not unrun, f"{path.name}: code cells {unrun} were never executed"
    errors = [o for c in code for o in c.get("outputs", [])
              if o.get("output_type") == "error"]
    assert not errors, f"{path.name}: {errors[0].get('ename')}"


@pytest.mark.parametrize("path", NOTEBOOKS, ids=lambda p: p.name)
def test_notebook_is_what_make_produces(path):
    nb = json.loads(path.read_text())
    want = make.notebook(make.cells_of(path.name, _parameters(nb)))["cells"]
    got = nb["cells"]
    assert [c["cell_type"] for c in got] == [c["cell_type"] for c in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert _source(g) == w["source"], (
            f"{path.name} cell {i} differs from its example: run python -m "
            "qgs_tpu_torch.notebooks.make --force, then "
            "qgs_tpu_torch.notebooks.run --device cpu")


@pytest.mark.parametrize("path", NOTEBOOKS, ids=lambda p: p.name)
def test_notebook_imports_no_jax(path):
    nb = json.loads(path.read_text())
    for cell in nb["cells"]:
        if cell["cell_type"] != "code":
            continue
        for node in ast.walk(ast.parse(_source(cell))):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "qgs_tpu"), (
                    f"{path.name} imports {name}")


@pytest.mark.parametrize("path", NOTEBOOKS, ids=lambda p: p.name)
def test_notebook_sets_its_device(path):
    """The committed notebooks ran on the CPU at short lengths, say so,
    and choose no device by themselves."""
    nb = json.loads(path.read_text())
    params = _parameters(nb)
    assert params["device"] == "cpu" and params["short"] is True
    note = [_source(c) for c in nb["cells"] if c["cell_type"] == "markdown"
            and "parameters" in c["metadata"].get("tags", [])]
    assert len(note) == 1 and "on the CPU (`device='cpu'`)" in note[0]
    text = "".join(_source(c) for c in nb["cells"])
    assert "cuda.is_available" not in text


def test_generator_keeps_executed_notebooks(tmp_path):
    written, skipped = make.write_all(out=tmp_path)
    assert len(written) == 17 and not skipped
    executed = tmp_path / make.INTRO
    nb = json.loads(executed.read_text())
    nb["cells"][2]["outputs"] = [{"output_type": "stream", "name": "stdout",
                                  "text": "ran"}]
    executed.write_text(json.dumps(nb))
    written, skipped = make.write_all(out=tmp_path)
    assert skipped == [make.INTRO] and len(written) == 16
    assert json.loads(executed.read_text())["cells"][2]["outputs"]
    written, skipped = make.write_all(force=True, out=tmp_path)
    assert len(written) == 17 and not skipped


def test_modules_import_without_the_notebook_tools():
    """``import qgs_tpu_torch.notebooks`` and its modules name no
    ``nbformat``, ``nbclient`` or IPython at module level (the card's host
    has none of them)."""
    for mod in ("__init__", "make", "run"):
        tree = ast.parse((NB_DIR / f"{mod}.py").read_text())
        top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                      ast.ImportFrom))]
        names = {a.name for n in top for a in n.names} | {
            n.module for n in top if isinstance(n, ast.ImportFrom)}
        assert not names & {"nbformat", "nbclient", "IPython",
                            "IPython.display", "markdown"}, (mod, names)
