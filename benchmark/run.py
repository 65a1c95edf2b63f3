#!/usr/bin/env python3
"""Run one cell of `BENCHMARK.json` once on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the set-up's phases, then each number the comparison checked with
its limit, on standard error, and as the last line of standard output one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics), `device`,
with `--trace 1` `breakdown`, `window` (its measured seconds and the
mean request wall of each fifth of it), and last `checks`.  Exits 2 without a
result when no card (or too few) is there, 3 when a module of the
benchmark imports JAX or the JAX package, or the process has loaded one
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from benchmark import importcheck

    bad = importcheck.faults()
    if bad:
        print(f"benchmark: forbidden imports {bad}", file=sys.stderr)
        return 3
    t = time.perf_counter()
    import torch

    from benchmark import cells, harness

    early = {"torch_import": time.perf_counter() - t}
    bench = cells.benchmark()
    cell = cells.cell(bench, args.workload)
    t = time.perf_counter()
    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    early["card_init"] = time.perf_counter() - t
    result, setup, compared = harness.run_cell(
        bench, cell, args.seed, args.seconds, bool(args.trace), device,
        T_START, early=early)
    left = importcheck.loaded()
    if left:
        print(f"benchmark: the process loaded {left}", file=sys.stderr)
        return 3
    from raytracing_gpu_tpu_torch.utils.profiling import card_line

    result["device"]["power_limit"] = card_line()
    print("window " + json.dumps(result["window"]), file=sys.stderr)
    print("setup " + json.dumps(setup), file=sys.stderr)
    for k, v in compared.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    # the checks come last in the result too
    result["checks"] = result.pop("checks")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
