"""Checkpoint and resume of a chunked render.

Counterpart of `raytracing_gpu_tpu/utils/checkpoint.py`: the float32
partial sums and the count of finished chunks in one npz, written to a
temporary file and renamed over the old one, so a render resumes exactly
where it stopped.  A checkpoint resumes only the render that wrote it: its
fingerprint hashes the settings (all but `num_chunks`), the seed and every
scene array, as host numpy arrays, so a checkpoint does not depend on the
device that wrote it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional, Tuple

import numpy as np

_FILE = "render_state.npz"


def _hash_scene(h, obj) -> None:
    """Every array of the scene, in field order: its shape, dtype and bytes
    (the tables, the background, the XLA engine's BVHs), and its flags."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _hash_scene(h, getattr(obj, f.name))
    elif isinstance(obj, tuple):  # a FlatBVH
        for x in obj:
            _hash_scene(h, x)
    elif isinstance(obj, np.ndarray):
        h.update(str(obj.shape).encode())
        h.update(str(obj.dtype).encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    else:
        h.update(repr(obj).encode())


def fingerprint(settings, seed: int, scene=None) -> str:
    """The identity of a render: its settings without `num_chunks` (a
    render may be resumed with more chunks), its seed and its scene."""
    h = hashlib.sha256()
    h.update(repr(settings.with_(num_chunks=0)).encode())
    h.update(str(int(seed)).encode())
    if scene is not None:
        _hash_scene(h, scene)
    return h.hexdigest()


def save(directory: str, sums: np.ndarray, chunks_done: int,
         fp: str = "") -> None:
    """Write the sums and the count of finished chunks atomically."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, sums=np.asarray(sums, np.float32),
                 chunks_done=np.int64(chunks_done),
                 fingerprint=np.bytes_(fp.encode()))
    os.replace(tmp, path)


def load(directory: str, expected_shape=None,
         fp: str = "") -> Optional[Tuple[np.ndarray, int]]:
    """(sums, chunks_done) of the checkpoint in `directory`, or None when
    there is none or it belongs to another render: another shape, another
    fingerprint, or no fingerprint where one is asked for."""
    path = os.path.join(directory, _FILE)
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        sums = data["sums"]
        chunks_done = int(data["chunks_done"])
        stored_fp = (bytes(data["fingerprint"]).decode()
                     if "fingerprint" in data.files else "")
    if expected_shape is not None and tuple(sums.shape) != tuple(
            expected_shape):
        return None
    if fp and stored_fp != fp:
        return None
    return sums, chunks_done


def clear(directory: str) -> None:
    """Remove the checkpoint in `directory`, if any."""
    path = os.path.join(directory, _FILE)
    if os.path.exists(path):
        os.remove(path)
