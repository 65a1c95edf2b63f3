"""The traced window: a few requests under `torch.profiler`, reduced to
what the per-layer metrics and the result's breakdown read.

The device's busy time is the union of its kernel, copy and set
intervals; the window is the host clock from the synchronize before the
first profiled request to the one after the last.  An idle gap of the
device is charged to the innermost host operation under way at each
moment of it: each request runs under a host annotation
(`benchmark.render`, `benchmark.train`), so a gap in which the host runs
no torch operation, such as numpy's tone mapping, is charged to the
request.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


@dataclass
class Profile:
    """The traced window: its requests, busy and window seconds, device
    seconds by kernel name, and the breakdown's two lists."""

    items: list
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def kernel_seconds(self, fragment: str) -> float:
        """Device seconds of the kernels whose name holds `fragment`."""
        return sum(s for name, s in self.kernels.items() if fragment in name)


def short_name(name: str) -> str:
    """A kernel or operation name cut to 64 characters of [A-Za-z0-9_.:-]."""
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(host: list) -> list:
    """The host timeline as (start, end, name) pieces of the innermost
    operation under way."""
    pieces, stack = [], []
    events = sorted(host, key=lambda e: (e[0], -e[1]))

    def emit(until):
        nonlocal cursor
        if stack and until > cursor:
            pieces.append((cursor, until, stack[-1][2]))
        cursor = max(cursor, until)

    cursor = events[0][0] if events else 0.0
    for a, b, name in events:
        while stack and stack[-1][1] <= a:
            emit(stack[-1][1])
            stack.pop()
        emit(a)
        stack.append((a, b, name))
    while stack:
        emit(stack[-1][1])
        stack.pop()
    return pieces


def reduce_trace(trace: dict) -> tuple:
    """(busy seconds, {kernel: seconds}, device_ops, idle_gaps) of a
    Chrome trace's events (times in microseconds)."""
    dev, host = [], []
    kernels = defaultdict(float)
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            dev.append((a, a + d))
            kernels[e["name"]] += d / 1e6
        elif e.get("cat") in HOST_CATS:
            host.append((a, a + d, e["name"]))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    charged = defaultdict(float)
    pieces = _innermost(host)
    j = 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                charged[pieces[k][2]] += (hi - lo) / 1e6
            k += 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(charged.items(), key=lambda kv: -kv[1])[:TOP]
    return (busy_s, dict(kernels),
            [[short_name(n), s] for n, s in top],
            [[short_name(n), s] for n, s in idle])


def profile(load, n: int) -> Profile:
    """`n` requests of `load` under the profiler (CPU and CUDA activity),
    reduced by `reduce_trace`; the Chrome trace goes to a temporary file
    that is removed."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    device = load.device
    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        items = []
        for _ in range(n):
            with record_function(f"benchmark.{load.kind}"):
                items.append(load.request(True))
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    busy_s, kernels, ops, idle = reduce_trace(trace)
    return Profile(items=items, window_s=window_s, busy_s=busy_s,
                   kernels=kernels, device_ops=ops, idle_gaps=idle)
