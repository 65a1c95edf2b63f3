"""Profiling & observability (counterpart of
`raytracing_gpu_tpu/utils/profiling.py`): a logger, per-phase wall-clock
timing, a rays/s gauge that synchronizes a CUDA device at both ends of
the timed region, so it measures the device's work and not the enqueue, a
`torch.profiler` trace context (`device_trace`), the device time of a
call's kernels by name (`kernel_times`) and the NaN check's switch for
every render (`enable_nan_debugging`).
"""

from __future__ import annotations

import contextlib
import logging
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

logger = logging.getLogger("raytracing_gpu_tpu_torch")

_debug_nans = False  # enable_nan_debugging: every render_linear checks



def synchronize(device: Optional[torch.device | str]) -> None:
    """Wait for a CUDA device's queued work; a no-op for the CPU or None."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class RaysPerSecond:
    """Rays/s gauge: wrap a timed region and read `.mrays`."""

    seconds: float = 0.0
    rays: int = 0

    @contextlib.contextmanager
    def measure(self, rays: int, device: Optional[torch.device | str] = None):
        """Time the region; on a CUDA `device`, synchronize before and after
        it."""
        synchronize(device)
        t0 = time.perf_counter()
        yield
        synchronize(device)
        self.seconds = time.perf_counter() - t0
        self.rays = rays

    @property
    def mrays(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds else 0.0


@dataclass
class PhaseTimer:
    """Per-phase wall-clock timing (build / trace / io).  `render_linear`
    also sets `engine`, the route its chunks took, and `steps`, the host
    steps of a regen route's chunks summed (one `rt_hit` launch each;
    None on the other routes)."""

    phases: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    engine: Optional[str] = None
    steps: Optional[int] = None

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.phases.values()) or 1.0
        lines = [
            f"{name:>12}: {dt:8.3f}s ({100 * dt / total:5.1f}%) x{self.counts[name]}"
            for name, dt in sorted(self.phases.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str],
                 device: Optional[torch.device | str] = None,
                 name: str = "trace.json"):
    """A `torch.profiler` over the host and, on a CUDA `device`, the
    device, that writes its Chrome trace (Perfetto reads it) to
    `log_dir/name` when the region ends; yields the profiler.  A no-op
    that yields None when `log_dir` is None (`jax.profiler.trace`'s
    counterpart)."""
    if log_dir is None:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, name))


def kernel_times(fn) -> Dict[str, tuple]:
    """Run `fn()` once under `torch.profiler` with CUDA activity alone and
    return its kernels' device time by kernel name: {name: (seconds,
    launches)}.  The profiler drops kernel records: a few of a long window,
    and, in a process that has already profiled long runs of many
    thousands of kernels, every record of a window of a few kernels (H100,
    torch 2.11), so the sums are lower bounds, and a short window is best
    profiled in a process of its own."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0.0)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.key] = (us / 1e6, evt.count)
    return out


def enable_nan_debugging(enable: bool = True) -> None:
    """JAX's `jax_debug_nans` switch for the port: from now on every
    `engine.render.render_linear` checks each chunk's sums and raises
    FloatingPointError on the first NaN (one host read a chunk).  The
    check is `render_linear`'s one: it runs when this switch OR its
    `debug_nans` argument is on.  `enable=False` turns the switch off
    again."""
    global _debug_nans
    _debug_nans = bool(enable)


def nan_debugging() -> bool:
    """Whether `enable_nan_debugging` is on."""
    return _debug_nans


def card_line() -> Optional[str]:
    """The card's name and power limit as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` prints them, or None where
    nvidia-smi cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
