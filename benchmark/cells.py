"""`BENCHMARK.json` and the files it names, found by name: a cell's
configuration (`configs/<config>.json`), traffic (`traffic/<traffic>.json`),
the kind of request its traffic names (`kinds/<kind>.py`), limits
(`limits/<cell>.json`) and a metric's reader (`metrics/<metric>.py`,
whose `read(run)` returns a number or None)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def kind(name: str):
    """The module `kinds/<name>.py` that makes a traffic kind's requests."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise KeyError(f"no traffic kind {name!r}")
    return importlib.import_module(f"benchmark.kinds.{name}")


def limits(cell_name: str) -> dict:
    return _json(os.path.join(HERE, "limits", f"{cell_name}.json"))


def metrics(bench: dict, cell_name: str, section: str) -> list:
    """The metrics of `section` ("end_to_end" or "per_layer") that the
    cell reports: those that list it, or list no cells."""
    return [m for m in bench[section]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str):
    """The `read` function of `metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
