"""Find a cell's files by name.

* ``workloads/<cell>.json``: the cell: its configuration, traffic,
  chips, the kernels each call must launch, its metrics, the calls traced
  and the limits of its comparison;
* ``configs/<config>.json``: the model configuration;
* ``traffic/<traffic>.json``: the traffic mix: the job that drives it and
  the job's parameters;
* ``jobs/<job>.py``: the loop the window drives;
* ``metrics/<metric>.py``: the reader of one metric.

A new cell, configuration, traffic, job or metric is a new file: nothing
here lists them."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _path(kind, name, suffix, root=None):
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a {kind} name")
    path = pathlib.Path(root or ROOT) / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{kind}: no file for {name!r} ({path})")
    return path


def _json(kind, name, root):
    return json.loads(_path(kind, name, ".json", root).read_text())


def workload(name, root=None):
    return _json("workloads", name, root)


def config(name, root=None):
    return _json("configs", name, root)


def traffic(name, root=None):
    return _json("traffic", name, root)


def _module(kind, name, root):
    path = _path(kind, name, ".py", root)
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def job(name, root=None):
    return _module("jobs", name, root)


def metric(name, root=None):
    return _module("metrics", name, root)


def cell(name, root=None):
    """The cell's workload, configuration and traffic files and its job
    module, as one dict."""
    wl = workload(name, root)
    tr = traffic(wl["traffic"], root)
    return {"workload": wl, "config": config(wl["config"], root),
            "traffic": tr, "job": job(tr["job"], root)}
