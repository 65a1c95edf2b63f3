"""Carry a scene and a camera across from the JAX package.

A scene's "weights" are its tables.  The JAX package keeps them as a pytree
of arrays; these functions take that pytree's leaves as numpy arrays, in
nested dicts keyed by the same field names, and build the port's `Scene` and
`Camera`.  The port never imports JAX: the caller flattens the JAX objects to
numpy (for example from `jax.device_get(scene)` or the host snapshot that
`SceneBuilder.build` keeps).  The differentiable parameters travel the same
way (`params_from_numpy`).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .accel.bvh import FlatBVH
from .core.camera import Camera
from .engine.diff import PARAM_KEYS
from .scene import types as st

_DTYPES = {np.dtype(np.float32), np.dtype(np.int32), np.dtype(np.bool_)}


def _array(name: str, value) -> np.ndarray:
    a = np.asarray(value)
    if a.dtype not in _DTYPES:
        raise TypeError(f"{name}: expected float32, int32 or bool leaves, "
                        f"got {a.dtype}")
    return a


def scene_from_numpy(tree: Mapping) -> st.Scene:
    """Port `Scene` from {table name: {field: array}, "background": (3,),
    "has_sphere_media": bool, "has_box_media": bool}, with the XLA
    engine's `sphere_bvh` and `tri_bvh` ({field: array} of a FlatBVH, or
    None) where the tree has them.  The kernel bake builds its own BVHs
    from the sphere and triangle tables (`ops.cuda_trace.bake_scene`)."""
    tables = {}
    for name, cls in st.TABLES.items():
        leaves = tree[name]
        tables[name] = cls(**{
            f.name: _array(f"{name}.{f.name}", leaves[f.name])
            for f in dataclasses.fields(cls)})
    return st.Scene(
        **tables,
        background=_array("background", tree["background"]).astype(np.float32),
        has_sphere_media=bool(tree["has_sphere_media"]),
        has_box_media=bool(tree["has_box_media"]),
        **{k: _bvh(k, tree.get(k)) for k in ("sphere_bvh", "tri_bvh")},
    )


def _bvh(name: str, leaves) -> FlatBVH | None:
    if leaves is None:
        return None
    return FlatBVH(**{f: _array(f"{name}.{f}", leaves[f])
                      for f in FlatBVH._fields})


def camera_from_numpy(tree: Mapping,
                      device: torch.device | str = "cpu") -> Camera:
    """Port `Camera` from {field: float32 array} (the JAX camera's leaves)."""
    return Camera(**{
        f.name: torch.tensor(np.asarray(tree[f.name], np.float32),
                             device=device)
        for f in dataclasses.fields(Camera)})


def params_from_numpy(tree: Mapping, device: torch.device | str = "cuda"
                      ) -> dict:
    """Port parameter dict (`engine.diff.get_params`'s form) from the JAX
    package's parameter pytree as numpy: {"tex_c1", "tex_c2",
    "atlas_data"} -> float32 tensors on `device`."""
    missing = set(PARAM_KEYS) - set(tree)
    extra = set(tree) - set(PARAM_KEYS)
    if missing or extra:
        raise KeyError(f"expected parameters {PARAM_KEYS}, missing "
                       f"{sorted(missing)}, unexpected {sorted(extra)}")
    out = {}
    for k in PARAM_KEYS:
        a = _array(k, tree[k])
        if a.dtype != np.float32:
            raise TypeError(f"{k}: expected float32, got {a.dtype}")
        out[k] = torch.tensor(a, device=device)
    return out
