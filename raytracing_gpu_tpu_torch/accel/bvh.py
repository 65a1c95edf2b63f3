"""Host-side BVH construction into flat, stackless-traversable arrays.

Counterpart of `raytracing_gpu_tpu/accel/bvh.py` (`FlatBVH`, `build`), with
the native binned-SAH builder only (`..native`).  The layout is the JAX
package's:

- nodes in DFS preorder,
- `hit_link[i]`: the next node when node i's box is hit (its first child;
  for a leaf the same as `miss_link`, after its primitives are tested),
- `miss_link[i]`: the next node when the box is missed (past the subtree),
  -1 at the end of the walk,
- `leaf_prims[i]`: up to K primitive ids, -1 padded; all -1 for an
  internal node.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .. import native

BBOX_PAD = 1e-4  # degenerate-extent padding (reference triangle.h:80-93)


class FlatBVH(NamedTuple):
    node_min: np.ndarray    # (M, 3) float32
    node_max: np.ndarray    # (M, 3) float32
    hit_link: np.ndarray    # (M,) int32
    miss_link: np.ndarray   # (M,) int32
    leaf_prims: np.ndarray  # (M, K) int32, -1 = none


def build(bounds_min: np.ndarray, bounds_max: np.ndarray,
          leaf_size: int = 4) -> FlatBVH:
    """Flat BVH over primitives given their (P, 3) bounds, P > 0."""
    if len(bounds_min) == 0:
        raise ValueError("a BVH needs at least one primitive")
    return FlatBVH(*native.build_bvh_native(bounds_min, bounds_max,
                                            leaf_size))


def build_triangle_bvh(tri_cols: dict, leaf_size: int = 4) -> FlatBVH:
    """BVH over the builder's triangle columns (a dict of (P, 3) v0, e1, e2
    arrays, `SceneBuilder._tri_columns`; `accel.bvh.build_triangle_bvh`):
    each triangle's box over its vertices, a flat extent padded by
    BBOX_PAD (reference `triangle.h:80-93`).  Primitive ids are the rows
    of the packed triangle table."""
    v0 = np.asarray(tri_cols["v0"])
    v1 = v0 + np.asarray(tri_cols["e1"])
    v2 = v0 + np.asarray(tri_cols["e2"])
    bmin = np.minimum(np.minimum(v0, v1), v2)
    bmax = np.maximum(np.maximum(v0, v1), v2)
    flat = (bmax - bmin) < 1e-6
    bmin = np.where(flat, bmin - BBOX_PAD, bmin)
    bmax = np.where(flat, bmax + BBOX_PAD, bmax)
    return build(bmin.astype(np.float32), bmax.astype(np.float32), leaf_size)


def build_sphere_bvh(sphere_rows, leaf_size: int = 4) -> FlatBVH | None:
    """BVH over the non-medium rows of the builder's sphere list
    (`accel.bvh.build_sphere_bvh`): a moving sphere's box is the union of
    its boxes at t0 and t1 (reference `moving_sphere::bounding_box`).  Its
    leaf ids are rows of the packed sphere table; media are left out (the
    engine samples them apart).  None when every sphere is a medium."""
    ids = np.array([i for i, s in enumerate(sphere_rows) if not s["medium"]],
                   np.int32)
    if len(ids) == 0:
        return None
    c0 = np.stack([sphere_rows[i]["c0"] for i in ids])
    c1 = np.stack([sphere_rows[i]["c1"] for i in ids])
    r = np.abs(np.array([sphere_rows[i]["r"] for i in ids]))[:, None]
    bvh = build(np.minimum(c0 - r, c1 - r).astype(np.float32),
                np.maximum(c0 + r, c1 + r).astype(np.float32), leaf_size)
    lp = bvh.leaf_prims
    remapped = np.where(lp >= 0, ids[np.clip(lp, 0, len(ids) - 1)], -1)
    return bvh._replace(leaf_prims=remapped.astype(np.int32))
