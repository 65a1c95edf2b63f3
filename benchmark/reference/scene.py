"""A scene of the configuration file, as the reference reads it.

The reference's own tables, worked out from the file's primitives: every
value is rounded once to float32, as a renderer that keeps its scene in
float32 holds it.  Materials are numbered in the file's order, then one
isotropic material a medium in the media's order; material i's albedo is
parameter row i.  The camera's basis is computed in float32 on the host
(reference `camera.h:18-47`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

LAMBERTIAN, DIFFUSE_LIGHT, ISOTROPIC = "lambertian", "diffuse_light", \
    "isotropic"
KINDS = (LAMBERTIAN, DIFFUSE_LIGHT, ISOTROPIC)
PLANE_AXIS = {"yz": 0, "xz": 1, "xy": 2}  # the axis a rect is normal to


def f32(x) -> float:
    """`x` rounded to float32, as a Python float."""
    return float(np.float32(x))


@dataclass(frozen=True)
class Camera:
    """The thin-lens camera's constants: origin, lower-left corner,
    horizontal and vertical extent (each three floats), the lens radius
    and the image's height and width."""

    origin: tuple
    llc: tuple
    hor: tuple
    ver: tuple
    lens_radius: float
    height: int
    width: int

    @property
    def inv_w(self) -> float:
        return f32(1.0 / max(self.width - 1, 1))

    @property
    def inv_h(self) -> float:
        return f32(1.0 / max(self.height - 1, 1))


@dataclass(frozen=True)
class Scene:
    """Rects (axis, a0, a1, b0, b1, k, material), boxes and box media
    (bmin, bmax, cos, sin, offset, material; a medium also its -1 /
    density), the materials' kinds and float32 albedos, the background."""

    rects: tuple
    boxes: tuple
    media: tuple
    kinds: tuple
    albedo: np.ndarray  # (M, 3) float32
    background: tuple

    @property
    def n_materials(self) -> int:
        return len(self.kinds)


def _box(p0, p1, rotate_y: float, translate) -> dict:
    theta = math.radians(float(rotate_y))
    lo = np.minimum(np.asarray(p0, np.float32), np.asarray(p1, np.float32))
    hi = np.maximum(np.asarray(p0, np.float32), np.asarray(p1, np.float32))
    return dict(bmin=tuple(float(v) for v in lo),
                bmax=tuple(float(v) for v in hi),
                cos=f32(math.cos(theta)), sin=f32(math.sin(theta)),
                off=tuple(f32(v) for v in translate))


def build_scene(spec: dict) -> Scene:
    """The reference's scene from a configuration's "scene" object."""
    names = list(spec["materials"])
    kinds = [spec["materials"][n]["kind"] for n in names]
    albedo = [spec["materials"][n]["albedo"] for n in names]
    for k in kinds:
        if k not in (LAMBERTIAN, DIFFUSE_LIGHT):
            raise ValueError(f"surface material kind {k!r}")
    mat = {n: i for i, n in enumerate(names)}
    rects = []
    for r in spec.get("rects", []):
        rects.append(dict(axis=PLANE_AXIS[r["plane"]], a0=f32(r["a0"]),
                          a1=f32(r["a1"]), b0=f32(r["b0"]), b1=f32(r["b1"]),
                          k=f32(r["k"]), mat=mat[r["material"]]))
    boxes = [dict(_box(b["p0"], b["p1"], b.get("rotate_y", 0.0),
                       b.get("translate", (0, 0, 0))), mat=mat[b["material"]])
             for b in spec.get("boxes", [])]
    media = []
    for m in spec.get("media", []):
        kinds.append(ISOTROPIC)
        albedo.append(m["albedo"])
        media.append(dict(_box(m["p0"], m["p1"], m.get("rotate_y", 0.0),
                               m.get("translate", (0, 0, 0))),
                          nid=f32(-1.0 / float(m["density"])),
                          mat=len(kinds) - 1))
    return Scene(rects=tuple(rects), boxes=tuple(boxes), media=tuple(media),
                 kinds=tuple(kinds),
                 albedo=np.asarray(albedo, np.float32).reshape(-1, 3),
                 background=tuple(f32(v) for v in spec["background"]))


def _unit(a: torch.Tensor) -> torch.Tensor:
    length = torch.sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2])
    return a * torch.reciprocal(torch.clamp(length, min=1e-20))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack((a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]))


def build_camera(spec: dict, height: int, width: int) -> Camera:
    """The camera of a configuration's "camera" object for a
    height x width image; the basis in float32 on the host."""
    def t(x):
        return torch.as_tensor(x, dtype=torch.float32)

    lookfrom, lookat, vup = t(spec["lookfrom"]), t(spec["lookat"]), \
        t(spec["vup"])
    aspect = float(spec["aspect_ratio"])
    focus = float(spec["focus_dist"])
    h = math.tan(math.radians(float(spec["vfov"])) / 2.0)
    vh = 2.0 * h
    vw = aspect * vh
    w = _unit(lookfrom - lookat)
    u = _unit(_cross(vup, w))
    v = _cross(w, u)
    horizontal = focus * vw * u
    vertical = focus * vh * v
    llc = lookfrom - horizontal / 2.0 - vertical / 2.0 - focus * w

    def tup(x):
        return tuple(float(c) for c in x.tolist())

    return Camera(origin=tup(lookfrom), llc=tup(llc), hor=tup(horizontal),
                  ver=tup(vertical),
                  lens_radius=f32(float(spec["aperture"]) / 2.0),
                  height=int(height), width=int(width))
