"""One short run of each cell on the card through `run.py`."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import cells

ROOT = cells.ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells.benchmark()["workloads"],
                         ids=lambda w: w["name"])
def test_run_prints_a_correct_result(cell, cuda_device):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", cell["name"], "--seed", "2147487649",
         "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
