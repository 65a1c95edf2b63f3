"""The finished image: the mean over samples, gamma 2 and the 8-bit scale
(reference `color.h:32-47`), in the precisions a render uses: float32
sums, a float32 mean, then float64 tone mapping."""

from __future__ import annotations

import numpy as np


def finalize(sums: np.ndarray, samples: int) -> tuple:
    """(image in [0, 1) float64, uint8 image) of float32 sample sums."""
    mean = np.asarray(sums, np.float32) / np.float32(samples)
    total = (mean * np.float32(samples)).astype(np.float64)
    g = np.clip(np.sqrt(np.maximum(total / samples, 0.0)), 0.0, 0.999)
    return g, (256.0 * np.clip(g, 0.0, 0.999)).astype(np.uint8)
