"""Profiling & observability (counterpart of
`raytracing_gpu_tpu/utils/profiling.py`): a logger, per-phase wall-clock
timing, and a rays/s gauge that synchronizes a CUDA device at both ends of
the timed region, so it measures the device's work and not the enqueue.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

logger = logging.getLogger("raytracing_gpu_tpu_torch")


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
    """Per-phase wall-clock timing (build / trace / io)."""

    phases: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

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
