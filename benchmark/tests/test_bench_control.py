"""The comparison fails its control and every planted fault, and passes
a sound run: the harness driven on the CPU at a tiny size, its look for
a card skipped."""

import time

import pytest
import torch

from benchmark import cells, check, control, harness
from benchmark.kinds import render, train
from benchmark.tests.conftest import SEED, TINY

BENCH = cells.benchmark()
RENDER = [w for w in BENCH["workloads"] if w["traffic"] == "final"]
TRAIN = [w for w in BENCH["workloads"] if w["traffic"] == "train"]
CPU = torch.device("cpu")


def _run(cell, plant=None, seed=SEED):
    """A tiny run whose window holds several requests."""
    result, _, compared = harness.run_cell(
        BENCH, cell, seed, 1.0, False, CPU, time.perf_counter(),
        plant=plant, overrides=TINY)
    return result, compared


@pytest.mark.parametrize("cell", RENDER + TRAIN, ids=lambda w: w["name"])
def test_sound_run_is_correct(cell):
    result, compared = _run(cell)
    assert result["correct"], compared
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1


@pytest.mark.parametrize("fault", ["stale", "half", "alter"])
@pytest.mark.parametrize("cell", RENDER, ids=lambda w: w["name"])
def test_render_fault_is_caught(cell, fault, monkeypatch):
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    monkeypatch.setattr(cuda_trace.Tracer, "bind_chunk",
                        getattr(render._alter, "bind_chunk",
                                cuda_trace.Tracer.bind_chunk))
    result, compared = _run(cell, render.PLANTS[fault])
    assert not result["correct"], compared


@pytest.mark.parametrize("fault", ["unchanged", "half", "alter"])
@pytest.mark.parametrize("cell", TRAIN, ids=lambda w: w["name"])
def test_train_fault_is_caught(cell, fault):
    result, compared = _run(cell, train.PLANTS[fault])
    assert not result["correct"], compared


@pytest.mark.parametrize("cell", RENDER + TRAIN, ids=lambda w: w["name"])
def test_control_fails(cell, monkeypatch):
    """The bfloat16 reference in the port's place is not correct."""
    monkeypatch.setattr(cells, "config", lambda name, f=cells.config:
                        harness._merge(f(name), TINY["config"]))
    monkeypatch.setattr(cells, "traffic", lambda name, f=cells.traffic:
                        harness._merge(f(name), TINY["traffic"]))
    numbers = control.control_numbers(cell, SEED, CPU)
    assert not check.verdict(numbers, cells.limits(cell["name"])), numbers
