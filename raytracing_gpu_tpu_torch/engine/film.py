"""Film: tone mapping and image output (counterpart of
`raytracing_gpu_tpu/engine/film.py`).

The same gamma-2 (sqrt) + clamp transfer as the reference's
`write_frame_buffer` (`color.h:32-47`).  PNG is encoded with the standard
library (zlib + struct), so writing an image needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def finalize(sample_sum: np.ndarray, samples_per_pixel: int) -> np.ndarray:
    """Mean + gamma-2 + clamp (reference `color.h:32-43`).

    sample_sum: (H, W, 3) float sum of linear radiance samples.
    Returns (H, W, 3) float in [0, 1).
    """
    mean = np.asarray(sample_sum, np.float64) / max(samples_per_pixel, 1)
    g = np.sqrt(np.maximum(mean, 0.0))  # guarded against negative fireflies
    return np.clip(g, 0.0, 0.999)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1) float -> [0, 255] uint8 (reference `color.h:44-47` scale 256)."""
    return (256.0 * np.clip(img, 0.0, 0.999)).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """8-bit RGB PNG, one IDAT chunk, filter 0 on every row (reference
    writes via png++, `color.h:139-168`)."""
    data = to_uint8(img)
    h, w, _ = data.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           data.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def write_ppm(path: str, img: np.ndarray) -> None:
    """P3 PPM writer for parity with `write_frame_buffer` (`color.h:19-49`)."""
    h, w, _ = img.shape
    data = to_uint8(img)
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        for row in data:
            for px in row:
                f.write(f"{px[0]} {px[1]} {px[2]}\n")
