#!/usr/bin/env python3
"""Read the comparison's control and its planted faults at a cell's own
size: the readings its limits are set from (`limits/<cell>.json`).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --mode <mode> [--seconds s]

Modes:

- `control`: the reference computed in bfloat16, the precision below the
  configuration's float32, put in the port's place: a render cell's kept
  pixels of the requests a run would check, a training cell's first
  steps.  Needs no window and does not run the port.
- a fault of the cell's kind (`PLANTS` of `kinds/<kind>.py`) planted in
  the timed path, then a whole run through `harness.run_cell`
  (`--seconds` of window).  Renders: `stale` (every render returns the
  first one's image), `half` (half its chunks, the mean over what is
  left), `alter` (one added to the first wave's sums of every chunk where
  the chunk is produced).  Steps: `unchanged` (the parameters left as
  they were), `half` (half its samples, the mean over what is left),
  `alter` (as a render's).

Prints one JSON line a seed: the mode, the seed and the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kind(cell: dict):
    from benchmark import cells

    return cells.kind(cells.traffic(cell["traffic"])["kind"])


def control_numbers(cell: dict, seed: int, device) -> dict:
    """The control's numbers for one seed: the bfloat16 reference in the
    port's place, drawn as a run with this seed draws its requests."""
    from benchmark import cells

    return _kind(cell).control_numbers(cells.config(cell["config"]),
                                       cells.traffic(cell["traffic"]),
                                       seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True,
                    help="control, or a fault of the cell's kind")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import cells, harness

    if not torch.cuda.is_available():
        print("control: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench = cells.benchmark()
    cell = cells.cell(bench, args.workload)
    plants = _kind(cell).PLANTS
    if args.mode != "control" and args.mode not in plants:
        print(f"control: {cell['name']} has no fault {args.mode!r} "
              f"({', '.join(plants)})", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.mode == "control":
            numbers = control_numbers(cell, seed, device)
        else:
            _, _, compared = harness.run_cell(
                bench, cell, seed, args.seconds, False, device,
                time.perf_counter(), plant=plants[args.mode])
            numbers = {k: v["value"] for k, v in compared.items()}
        print(json.dumps({"workload": cell["name"], "mode": args.mode,
                          "seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
