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
