"""Scene representation: structure-of-arrays tables.

Counterpart of `raytracing_gpu_tpu/scene/types.py`.  The tags keep the JAX
package's integer values, and every table keeps its field names, so a scene
converts between the packages field by field (`convert.py`).  Here a table
is a frozen dataclass of host numpy arrays: the scene is baked on the host
into the small records the kernel reads (`ops/cuda_trace.py`), so nothing in
it needs to live on a device.

Every table is padded; `active` masks padding rows.  Float arrays are
float32, id arrays int32, masks bool.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

# Primitive type tags (order matters: used by closest-hit dispatch)
SPHERE, RECT, BOX, TRIANGLE = 0, 1, 2, 3

# Material kind tags (reference material.h classes)
LAMBERTIAN, METAL, DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC = 0, 1, 2, 3, 4

# Texture kind tags (reference texture.h classes)
TEX_SOLID, TEX_CHECKER, TEX_NOISE, TEX_TURB, TEX_MARBLE, TEX_IMAGE = 0, 1, 2, 3, 4, 5

# Rect orientation tags: the constant axis (reference yz_rect / xz_rect / xy_rect)
RECT_YZ, RECT_XZ, RECT_XY = 0, 1, 2

_table = dataclasses.dataclass(frozen=True)


def host_table(a, device: torch.device | str,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host table as a tensor on `device`.  The copy to a CUDA device is
    non-blocking (staged from pageable memory), so a per-wave caller does
    not wait for the device's queued work."""
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(device,
                                                          non_blocking=True)


@_table
class Spheres:
    """Sphere + moving-sphere table (reference `sphere.h`, `moving_sphere.h`);
    a negative radius is the hollow-sphere trick."""

    center0: np.ndarray          # (S, 3)
    center1: np.ndarray          # (S, 3)
    time0: np.ndarray            # (S,)
    time1: np.ndarray            # (S,)
    radius: np.ndarray           # (S,) signed
    mat_id: np.ndarray           # (S,) int32
    active: np.ndarray           # (S,) bool
    medium: np.ndarray           # (S,) bool — constant-medium boundary
    neg_inv_density: np.ndarray  # (S,)
    u_off: np.ndarray            # (S,) texture-u phase in turns (rotate_y)


@_table
class Rects:
    """Axis-aligned rectangles (reference `aarect.h`).

    `axis` is the constant coordinate: RECT_YZ -> x = k, RECT_XZ -> y = k,
    RECT_XY -> z = k; (a0, a1) x (b0, b1) bound the two other coordinates in
    ascending axis order.
    """

    axis: np.ndarray    # (R,) int32 in {0, 1, 2}
    a0: np.ndarray      # (R,)
    a1: np.ndarray      # (R,)
    b0: np.ndarray      # (R,)
    b1: np.ndarray      # (R,)
    k: np.ndarray       # (R,)
    mat_id: np.ndarray  # (R,) int32
    active: np.ndarray  # (R,) bool


@_table
class Boxes:
    """Axis-aligned boxes under a rotate_y + translate instance transform
    (reference `box.h` + `hittable.h:31-143`), one slab test each."""

    bmin: np.ndarray             # (B, 3) object-space min corner
    bmax: np.ndarray             # (B, 3)
    cos_t: np.ndarray            # (B,) cos(theta) of rotate_y
    sin_t: np.ndarray            # (B,) sin(theta)
    offset: np.ndarray           # (B, 3) translate offset
    mat_id: np.ndarray           # (B,) int32
    active: np.ndarray           # (B,) bool
    medium: np.ndarray           # (B,) bool
    neg_inv_density: np.ndarray  # (B,)


@_table
class Triangles:
    """Triangle table (reference `triangle.h`): v0 + two edges."""

    v0: np.ndarray      # (T, 3)
    e1: np.ndarray      # (T, 3)
    e2: np.ndarray      # (T, 3)
    n0: np.ndarray      # (T, 3)
    n1: np.ndarray      # (T, 3)
    n2: np.ndarray      # (T, 3)
    uv0: np.ndarray     # (T, 2)
    uv1: np.ndarray     # (T, 2)
    uv2: np.ndarray     # (T, 2)
    has_vn: np.ndarray  # (T,) bool
    mat_id: np.ndarray  # (T,) int32
    active: np.ndarray  # (T,) bool


@_table
class Materials:
    """Material parameter table (reference `material.h:16-138`); tex_id is
    the albedo, or the emission for diffuse_light."""

    kind: np.ndarray    # (M,) int32
    tex_id: np.ndarray  # (M,) int32
    fuzz: np.ndarray    # (M,)
    ir: np.ndarray      # (M,)


@_table
class Textures:
    """Texture parameter table (reference `texture.h:12-164`)."""

    kind: np.ndarray      # (K,) int32
    c1: np.ndarray        # (K, 3)
    c2: np.ndarray        # (K, 3)
    scale: np.ndarray     # (K,)
    image_id: np.ndarray  # (K,) int32


@_table
class ImageAtlas:
    """Flat image-texture atlas (reference `texture.h:97-164`)."""

    data: np.ndarray    # (total_pixels * 3,) float32 in [0, 1]
    offset: np.ndarray  # (I,) int32
    width: np.ndarray   # (I,) int32
    height: np.ndarray  # (I,) int32


@_table
class Scene:
    """The whole packed scene."""

    spheres: Spheres
    rects: Rects
    boxes: Boxes
    triangles: Triangles
    materials: Materials
    textures: Textures
    atlas: ImageAtlas
    background: np.ndarray  # (3,) miss color (reference `scenes.h:69-78`)
    # the XLA engine's BVHs (accel.bvh.FlatBVH, accel/traverse.py), None
    # below the builder's threshold; the kernel bake builds its own from
    # the tables (ops/cuda_trace.py)
    tri_bvh: Optional[Any] = None
    sphere_bvh: Optional[Any] = None
    has_sphere_media: bool = True
    has_box_media: bool = True


TABLES = {"spheres": Spheres, "rects": Rects, "boxes": Boxes,
          "triangles": Triangles, "materials": Materials,
          "textures": Textures, "atlas": ImageAtlas}
