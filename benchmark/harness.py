"""One run of one cell: set-up, the measured window, the traced window,
the comparison, and the result line.

The traffic's kind (`kinds/<kind>.py`, found by name) sets the cell up
and judges what its window produced; this module does the rest alike
for every kind.  `run_cell` takes a device, so the tests drive it on the
CPU at a tiny size through the port's plain versions; `run.py` refuses
to run without a card.  `plant`, when given, is called with the load
before set-up drives it: the comparison's own tests use it to break the
timed path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from . import cells, check, generator, program, stats, traced


@dataclass
class Run:
    """What the metric readers read: the window's requests and measured
    seconds, the set-up, the traced window and a render's counted
    work."""

    kind: str
    items: list
    window_s: float
    setup_s: float
    profile: Optional[traced.Profile] = None
    work: Optional[tuple] = None   # (float32 operations, bytes) a render


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) else v
    return out


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             plant: Optional[Callable] = None,
             overrides: Optional[dict] = None,
             early: Optional[dict] = None) -> tuple:
    """Run `cell` once; returns (result dict, set-up phases, numbers
    compared with their limits).  `overrides` replace keys of the
    configuration ("config") and the traffic ("traffic"); `early` holds
    the caller's own set-up phases since `t_start`."""
    cfg = _merge(cells.config(cell["config"]), (overrides or {}).get("config"))
    tr = _merge(cells.traffic(cell["traffic"]),
                (overrides or {}).get("traffic"))
    limits = cells.limits(cell["name"])
    t = time.perf_counter()
    setup = dict(early or {})
    setup["process"] = t - t_start - sum(setup.values())

    def phase(name):
        nonlocal t
        now = time.perf_counter()
        setup[name] = now - t
        t = now

    from raytracing_gpu_tpu_torch.ops import build  # the port's kernels
    phase("import")
    if device.type == "cuda":
        build.load()
    phase("extension_load")
    rng = np.random.default_rng(seed)
    prog = program.build(cfg)
    phase("scene_build")
    kind = cells.kind(tr["kind"])
    load = kind.setup(prog, cfg, tr, rng, device, phase, plant)
    del prog  # the load holds what the window needs
    setup_s = time.perf_counter() - t_start

    items, window_s = generator.window(load, seconds, spans=trace)
    prof = traced.profile(load, int(tr["profile_requests"])) if trace \
        else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    numbers, work = kind.judge(load, items, cfg, tr, seed, device)
    run = Run(kind=load.kind, items=items, window_s=window_s,
              setup_s=setup_s, profile=prof, work=work)

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cells.metrics(bench, cell["name"], section):
        value = cells.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": check.verdict(numbers, limits),
              "attempted": len(items), "failed": 0, "metrics": metrics,
              "device": dev}
    n = len(items)
    result["window"] = {"seconds": window_s, "mean_ms_by_fifth": [
        1e3 * stats.mean([i["t1"] - i["t0"] for i in part])
        for part in (items[k * n // 5:(k + 1) * n // 5] for k in range(5))
        if part]}
    if prof is not None:
        dev["busy_s"], dev["window_s"] = prof.busy_s, prof.window_s
        result["breakdown"] = {"device_ops": prof.device_ops,
                               "idle_gaps": prof.idle_gaps}
    compared = {k: {"value": numbers[k], "limit": limits[k]}
                for k in limits}
    result["checks"] = compared
    return result, setup, compared
