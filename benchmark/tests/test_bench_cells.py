"""BENCHMARK.json and the files it names are found by name."""

import os
import re

import pytest

from benchmark import cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=[w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    cfg = cells.config(cell["config"])
    tr = cells.traffic(cell["traffic"])
    lim = cells.limits(cell["name"])
    assert cfg["name"] == cell["config"]
    kind = cells.kind(tr["kind"])
    for part in ("setup", "judge", "control_numbers"):
        assert callable(getattr(kind, part))
    assert kind.PLANTS
    assert lim and all(v > 0 for v in lim.values())
    for section in ("end_to_end", "per_layer"):
        assert cells.metrics(BENCH, cell["name"], section)
    assert "setup_s" in [m["name"] for m in
                         cells.metrics(BENCH, cell["name"], "end_to_end")]


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert callable(cells.reader(metric["name"]))
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])


def test_configs_are_files_under_paths():
    for c in BENCH["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(cells.ROOT, c["file"]))
        assert cells.config(c["name"])["source"] == c["source"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.cell(BENCH, "no_such.cell")


@pytest.mark.parametrize("name", ["no_such_kind", "../run", "render.x"])
def test_unknown_kind_is_refused(name):
    with pytest.raises((KeyError, ModuleNotFoundError)):
        cells.kind(name)
