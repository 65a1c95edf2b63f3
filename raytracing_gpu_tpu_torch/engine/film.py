"""Film: tone mapping, image output and the PPM ensemble average
(counterpart of `raytracing_gpu_tpu/engine/film.py`).

The same gamma-2 (sqrt) + clamp transfer as the reference's
`write_frame_buffer` (`color.h:32-47`).  PNG is encoded with the standard
library (zlib + struct), so writing an image needs no imaging package;
`read_png` reads back what `write_png` writes.
`read_ppm` and `average_images` are the reference's frame-buffer ensemble
(`color.h:57-137`): read the P3 files back and average them in linear
space.
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


def read_png(path: str) -> np.ndarray:
    """The (H, W, 3) uint8 pixels of a PNG as `write_png` writes it: 8-bit
    RGB, no interlace, filter 0 on every row.  Raises ValueError for
    another PNG, a bad signature or a chunk whose CRC does not match."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, bits, color, _, _, interlace = struct.unpack(
        ">IIBBBBB", chunks[b"IHDR"])
    if (bits, color, interlace) != (8, 2, 0) or b"IEND" not in chunks:
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    if rows.size != h * (1 + 3 * w):
        raise ValueError(f"{path}: {rows.size} bytes of rows for {w}x{h}")
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def write_ppm(path: str, img: np.ndarray) -> None:
    """P3 PPM writer for parity with `write_frame_buffer` (`color.h:19-49`)."""
    h, w, _ = img.shape
    data = to_uint8(img)
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        for row in data:
            for px in row:
                f.write(f"{px[0]} {px[1]} {px[2]}\n")


def read_ppm(path: str) -> np.ndarray:
    """Read a P3 PPM back to float64 [0, 1], (H, W, 3) (reference
    `average_images` re-reads its frame buffers, `color.h:57-137`)."""
    with open(path) as f:
        tokens = f.read().split()
    if tokens[:1] != ["P3"]:
        raise ValueError(f"{path}: not a P3 PPM")
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    vals = np.array(tokens[4:4 + w * h * 3], dtype=np.float64)
    return (vals / maxv).reshape(h, w, 3)


def average_images(images: list) -> np.ndarray:
    """Ensemble average in linear space of gamma-encoded [0, 1] images:
    de-gamma by squaring (`color.h:125`), average in float64, re-gamma by
    `sqrt`."""
    acc = np.zeros_like(images[0], dtype=np.float64)
    for img in images:
        acc += np.asarray(img, np.float64) ** 2
    return np.sqrt(acc / len(images))
