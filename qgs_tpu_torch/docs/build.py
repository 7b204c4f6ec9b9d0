"""
Documentation site
==================

Builds the port's static HTML site: the guide (``port_guide.md`` beside
this module) and an API page for every public module of
:mod:`qgs_tpu_torch`, with the signatures and docstrings of the classes
and functions each defines (the counterpart of the JAX package's
``tools/build_docs.py``, with no Sphinx: the standard library and the
``markdown`` package, imported inside the functions that use it).

Run as ``python -m qgs_tpu_torch.docs.build [OUTDIR]`` (default
``qgs_tpu_torch/docs/site``, which is not committed).
"""

from __future__ import annotations

import html
import importlib
import inspect
import pathlib
import pkgutil
import sys

HERE = pathlib.Path(__file__).resolve().parent
GUIDE = HERE / "port_guide.md"
PACKAGE = "qgs_tpu_torch"
MD_EXT = ["fenced_code", "tables", "toc"]

STYLE = """
body { font-family: sans-serif; margin: 0; color: #1a202c; line-height: 1.5; }
.wrap { display: flex; max-width: 1200px; margin: 0 auto; }
nav { width: 260px; flex-shrink: 0; padding: 1rem; font-size: 0.85rem;
      border-right: 1px solid #e2e8f0; height: 100vh; overflow-y: auto;
      position: sticky; top: 0; }
nav h3 { margin: 0.8rem 0 0.3rem; font-size: 0.75rem; color: #718096;
         text-transform: uppercase; }
nav a { display: block; color: #2b6cb0; text-decoration: none; }
main { padding: 1.5rem 2.5rem; min-width: 0; flex: 1; }
code, pre { font-family: monospace; font-size: 0.9em; background: #f7fafc; }
pre { padding: 0.7rem; overflow-x: auto; border: 1px solid #e2e8f0; }
table { border-collapse: collapse; }
th, td { border: 1px solid #cbd5e0; padding: 0.3rem 0.6rem; }
.sig { background: #eef5ff; border: 1px solid #c3dafe;
       padding: 0.4rem 0.8rem; margin: 1.2rem 0 0.3rem;
       font-family: monospace; white-space: pre-wrap; }
.doc { white-space: pre-wrap; background: none; border: none;
       font-family: inherit; padding: 0 0 0.5rem 1rem; }
.member { margin-left: 1.2rem; }
.kind { color: #805ad5; font-size: 0.75em; text-transform: uppercase;
        margin-right: 0.4rem; }
"""

PAGE = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>{title} - qgs_tpu_torch</title>
<style>{style}</style>
</head><body><div class="wrap">
<nav>{nav}</nav>
<main>{body}</main>
</div></body></html>
"""


def public_modules():
    """``(name, module)`` of the package and every module under it whose
    name has no leading underscore, imported, in name order."""
    pkg = importlib.import_module(PACKAGE)
    names = [PACKAGE] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, PACKAGE + ".")
        if not any(part.startswith("_") for part in m.name.split("."))]
    return [(name, importlib.import_module(name)) for name in sorted(names)]


def signature(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def docstring(obj, cls="doc"):
    doc = inspect.getdoc(obj)
    return f'<pre class="{cls}">{html.escape(doc)}</pre>' if doc else ""


def members(mod):
    """The classes and functions defined in ``mod`` (not imported into
    it), public, in source order."""
    found = []
    for name, obj in vars(mod).items():
        if (name.startswith("_")
                or not (inspect.isclass(obj) or inspect.isfunction(obj))
                or getattr(obj, "__module__", None) != mod.__name__):
            continue
        try:
            line = inspect.getsourcelines(obj)[1]
        except (OSError, TypeError):
            line = 1 << 30
        found.append((line, name, obj))
    return [(name, obj) for _, name, obj in sorted(found,
                                                   key=lambda t: t[0])]


def sig_div(kind, name, sig="", cls="sig"):
    return (f'<div class="{cls}" id="{html.escape(name)}"><span '
            f'class="kind">{kind}</span><b>{html.escape(name)}</b>'
            f'{html.escape(sig)}</div>')


def render_module(name, mod):
    """An API page's body: the module docstring, then each class (its
    signature, docstring, public methods and properties) and function."""
    parts = [f"<h1><code>{html.escape(name)}</code></h1>", docstring(mod)]
    for mname, obj in members(mod):
        if not inspect.isclass(obj):
            parts += [sig_div("def", mname, signature(obj)), docstring(obj)]
            continue
        parts += [sig_div("class", mname, signature(obj)), docstring(obj)]
        for aname, attr in sorted(vars(obj).items()):
            if aname.startswith("_"):
                continue
            if inspect.isfunction(attr):
                parts += [sig_div("method", aname, signature(attr),
                                  "sig member"),
                          docstring(attr, "doc member")]
            elif isinstance(attr, property):
                parts += [sig_div("property", aname, cls="sig member"),
                          docstring(attr.fget, "doc member")
                          if attr.fget else ""]
    return "\n".join(p for p in parts if p)


def build(out_dir):
    """Write the site into ``out_dir``: ``index.html`` (the guide) and
    ``api_<module>.html`` for each public module.  Returns the pages'
    names."""
    import markdown

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    mods = public_modules()
    nav = "\n".join(["<h3>Guide</h3>",
                     '<a href="index.html">The port: a guide</a>',
                     "<h3>API reference</h3>"]
                    + [f'<a href="api_{n}.html"><code>{n}</code></a>'
                       for n, _ in mods])
    pages = {"index.html": ("The port: a guide", markdown.markdown(
        GUIDE.read_text(), extensions=MD_EXT))}
    for name, mod in mods:
        pages[f"api_{name}.html"] = (name, render_module(name, mod))
    for fname, (title, body) in pages.items():
        (out_dir / fname).write_text(PAGE.format(
            title=html.escape(title), style=STYLE, nav=nav, body=body))
    return list(pages)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out_dir = pathlib.Path(argv[0]) if argv else HERE / "site"
    pages = build(out_dir)
    print(f"wrote {len(pages)} pages ({len(pages) - 1} API modules) to "
          f"{out_dir}")


if __name__ == "__main__":
    main()
