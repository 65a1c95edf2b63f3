"""The one request generator: a closed loop of one client, driven by a
traffic file.

A traffic file's "kind" names the module of `kinds/` that makes its
requests (`kinds/<kind>.py`); its other keys are that kind's parameters.
Every draw comes from a numpy generator seeded with the run's seed: the
same seed gives the same requests in the same order.
"""

from __future__ import annotations

import gc
import time

import torch

SEED_RANGE = 2**31 - 1


def sync(device: torch.device) -> None:
    """Wait for a card's queued work; nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def release(load, device: torch.device) -> None:
    """Drop the program's state before the reference runs."""
    load.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def window(load, seconds: float, spans: bool = False) -> tuple:
    """Requests back to back until `seconds` have passed; the window ends
    when the request under way finishes.  Returns (items, measured
    seconds from the window's start to that finish)."""
    items = []
    sync(load.device)
    t0 = time.perf_counter()
    while True:
        items.append(load.request(spans))
        if time.perf_counter() - t0 >= seconds:
            break
    return items, items[-1]["t1"] - t0
