"""Host-side scene construction.

Counterpart of `raytracing_gpu_tpu/scene/builder.py` for the dense scenes:
solid, checker, noise, turbulence and marble textures; lambertian, metal,
dielectric, diffuse_light and isotropic materials; spheres and moving
spheres (rotate_y + translate baked, a negative radius for a hollow
sphere), axis-aligned rects (with a pure translation), boxes under
rotate_y + translate, and constant media in a box or a sphere.  Still
refused, with the feature named (`NotImplementedError`): image textures,
triangles, meshes and a rotated rect (it lowers to triangles).  `build()`
packs the same numpy tables, with the same padding, as the host snapshot
that the JAX `SceneBuilder.build` keeps (`_host_np`); the kernel bake builds
its own sphere BVH from them (`ops/cuda_trace.py`), so the scene carries
none.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Union

import numpy as np

from .types import (
    DIELECTRIC,
    DIFFUSE_LIGHT,
    ISOTROPIC,
    LAMBERTIAN,
    METAL,
    RECT_XY,
    RECT_XZ,
    RECT_YZ,
    TEX_CHECKER,
    TEX_MARBLE,
    TEX_NOISE,
    TEX_SOLID,
    TEX_TURB,
    Boxes,
    ImageAtlas,
    Materials,
    Rects,
    Scene,
    Spheres,
    Textures,
    Triangles,
)

SKY = (0.7, 0.8, 1.0)      # reference `scenes.h:71`
BLACK = (0.0, 0.0, 0.0)    # reference `scenes.h:73`

ColorLike = Union[tuple, list, np.ndarray]
_PAD = 4  # pad primitive tables to a multiple of this


def _rot_y(p: np.ndarray, degrees: float) -> np.ndarray:
    """Rotate a point about the y axis (reference `hittable.h:107-121` world
    transform: x' = cos*x + sin*z, z' = -sin*x + cos*z)."""
    if degrees % 360.0 == 0.0:
        return np.asarray(p, np.float32)
    th = math.radians(degrees)
    c, s = math.cos(th), math.sin(th)
    x, y, z = (float(v) for v in np.asarray(p, np.float64))
    return np.asarray([c * x + s * z, y, -s * x + c * z], np.float32)


def _v3(x) -> np.ndarray:
    return np.asarray(x, np.float32).reshape(3)


def _not_ported(feature: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"{feature}: not yet ported")

    method.__doc__ = f"{feature}: not yet ported (raises NotImplementedError)."
    return method


@dataclass
class SceneBuilder:
    background: tuple = SKY
    seed: int = 1984  # reference world seed (`scenes.h:30`)

    _tex: list = field(default_factory=list)
    _mat: list = field(default_factory=list)
    _spheres: list = field(default_factory=list)
    _rects: list = field(default_factory=list)
    _boxes: list = field(default_factory=list)

    # -- textures (reference texture.h) ------------------------------------

    def solid(self, color: ColorLike) -> int:
        return self._add_tex(TEX_SOLID, c1=_v3(color))

    def checker(self, even: ColorLike, odd: ColorLike,
                scale: float = 10.0) -> int:
        # the reference hardcodes frequency 10 (`texture.h:40`)
        return self._add_tex(TEX_CHECKER, c1=_v3(even), c2=_v3(odd),
                             scale=scale)

    def noise(self, scale: float = 1.0) -> int:
        return self._add_tex(TEX_NOISE, scale=scale)

    def turbulence(self, scale: float = 1.0) -> int:
        return self._add_tex(TEX_TURB, scale=scale)

    def marble(self, scale: float = 1.0) -> int:
        return self._add_tex(TEX_MARBLE, scale=scale)

    image = _not_ported("image texture")

    def _add_tex(self, kind, c1=None, c2=None, scale=1.0) -> int:
        self._tex.append(dict(
            kind=kind, c1=_v3(c1 if c1 is not None else (0, 0, 0)),
            c2=_v3(c2 if c2 is not None else (0, 0, 0)), scale=float(scale),
            image_id=-1))
        return len(self._tex) - 1

    def _as_tex(self, t: Union[int, ColorLike]) -> int:
        """A texture id, or a color that becomes a solid texture."""
        if isinstance(t, (int, np.integer)):
            return int(t)
        return self.solid(t)

    # -- materials (reference material.h) ----------------------------------

    def lambertian(self, albedo: Union[int, ColorLike]) -> int:
        return self._add_mat(LAMBERTIAN, tex_id=self._as_tex(albedo))

    def metal(self, albedo: Union[int, ColorLike], fuzz: float = 0.0) -> int:
        return self._add_mat(METAL, tex_id=self._as_tex(albedo), fuzz=fuzz)

    def dielectric(self, ir: float) -> int:
        return self._add_mat(DIELECTRIC, ir=ir)

    def diffuse_light(self, emit: Union[int, ColorLike]) -> int:
        return self._add_mat(DIFFUSE_LIGHT, tex_id=self._as_tex(emit))

    def isotropic(self, albedo: Union[int, ColorLike]) -> int:
        return self._add_mat(ISOTROPIC, tex_id=self._as_tex(albedo))

    def _add_mat(self, kind, tex_id=0, fuzz=0.0, ir=1.0) -> int:
        self._mat.append(dict(kind=kind, tex_id=tex_id, fuzz=float(fuzz),
                              ir=float(ir)))
        return len(self._mat) - 1

    # -- primitives --------------------------------------------------------

    def sphere(self, center, radius: float, mat: int,
               rotate_y: float = 0.0, translate=(0.0, 0.0, 0.0)) -> None:
        """reference `sphere.h`; a negative radius is the hollow-sphere
        trick.  rotate_y/translate (`hittable.h:31-143`) are baked: the
        center is rotated about y then offset, and the uv phase shift of
        the object-space uv is kept as a per-sphere u offset."""
        c = _rot_y(_v3(center), rotate_y) + _v3(translate)
        self._spheres.append(
            dict(c0=c, c1=c, t0=0.0, t1=1.0, r=float(radius), mat=mat,
                 medium=False, nid=0.0, u_off=-rotate_y / 360.0))

    def moving_sphere(self, center0, center1, time0, time1, radius, mat: int,
                      rotate_y: float = 0.0,
                      translate=(0.0, 0.0, 0.0)) -> None:
        """reference `moving_sphere.h` (+ the baked instance transform)."""
        off = _v3(translate)
        self._spheres.append(
            dict(c0=_rot_y(_v3(center0), rotate_y) + off,
                 c1=_rot_y(_v3(center1), rotate_y) + off,
                 t0=float(time0), t1=float(time1), r=float(radius), mat=mat,
                 medium=False, nid=0.0, u_off=-rotate_y / 360.0))

    def rect(self, orientation: str, a0, a1, b0, b1, k, mat: int,
             rotate_y: float = 0.0, translate=(0.0, 0.0, 0.0)) -> None:
        """reference `aarect.h`: orientation in {"xy", "xz", "yz"}, argument
        order as the reference ctors, e.g. xy_rect(x0, x1, y0, y1, k).  A pure
        translation offsets the bounds; a rotation would lower the rect to
        triangles, which are not ported."""
        if rotate_y % 360.0 != 0.0:
            raise NotImplementedError(
                "rotated rect (lowers to triangles): not yet ported")
        axis = {"yz": RECT_YZ, "xz": RECT_XZ, "xy": RECT_XY}[orientation]
        tx, ty, tz = (float(x) for x in np.asarray(translate, np.float64))
        da, db, dk = {RECT_YZ: (ty, tz, tx), RECT_XZ: (tx, tz, ty),
                      RECT_XY: (tx, ty, tz)}[axis]
        self._rects.append(
            dict(axis=axis, a0=float(a0) + da, a1=float(a1) + da,
                 b0=float(b0) + db, b1=float(b1) + db, k=float(k) + dk,
                 mat=mat)
        )

    def box(self, p0, p1, mat: int, rotate_y: float = 0.0,
            translate=(0.0, 0.0, 0.0)) -> None:
        """reference `box.h` composed with rotate_y/translate instance
        wrappers (`hittable.h:31-143`, used by the Cornell scenes)."""
        self._add_box(p0, p1, mat, rotate_y, translate, medium=False,
                      density=0.0)

    def box_medium(self, p0, p1, density: float,
                   albedo: Union[int, ColorLike], rotate_y: float = 0.0,
                   translate=(0.0, 0.0, 0.0)) -> None:
        """reference `constant_medium` with a box boundary
        (`scenes.h:383-394`)."""
        mat = self.isotropic(albedo)
        self._add_box(p0, p1, mat, rotate_y, translate, medium=True,
                      density=density)

    def sphere_medium(self, center, radius: float, density: float,
                      albedo: Union[int, ColorLike], rotate_y: float = 0.0,
                      translate=(0.0, 0.0, 0.0)) -> None:
        """reference `constant_medium` with a sphere boundary."""
        mat = self.isotropic(albedo)
        c = _rot_y(_v3(center), rotate_y) + _v3(translate)
        self._spheres.append(
            dict(c0=c, c1=c, t0=0.0, t1=1.0, r=float(radius), mat=mat,
                 medium=True, nid=-1.0 / float(density), u_off=0.0))

    def _add_box(self, p0, p1, mat, rotate_y, translate, medium, density):
        theta = math.radians(rotate_y)
        self._boxes.append(
            dict(bmin=np.minimum(_v3(p0), _v3(p1)),
                 bmax=np.maximum(_v3(p0), _v3(p1)),
                 cos=math.cos(theta), sin=math.sin(theta), off=_v3(translate),
                 mat=mat, medium=medium,
                 nid=(-1.0 / float(density)) if medium else 0.0))

    triangle = _not_ported("triangles")
    mesh = _not_ported("triangle meshes")

    # -- packing -----------------------------------------------------------

    def build(self) -> Scene:
        """Pack everything into the Scene tables (host numpy arrays)."""
        if not self._mat:
            self.lambertian((0.5, 0.5, 0.5))
        if not self._tex:
            self.solid((0.5, 0.5, 0.5))
        materials = Materials(
            kind=np.asarray([m["kind"] for m in self._mat], np.int32),
            tex_id=np.asarray([m["tex_id"] for m in self._mat], np.int32),
            fuzz=np.asarray([m["fuzz"] for m in self._mat], np.float32),
            ir=np.asarray([m["ir"] for m in self._mat], np.float32),
        )
        textures = Textures(
            kind=np.asarray([t["kind"] for t in self._tex], np.int32),
            c1=np.stack([t["c1"] for t in self._tex]).astype(np.float32),
            c2=np.stack([t["c2"] for t in self._tex]).astype(np.float32),
            scale=np.asarray([t["scale"] for t in self._tex], np.float32),
            image_id=np.asarray([t["image_id"] for t in self._tex], np.int32),
        )
        return Scene(
            spheres=self._pack_spheres(), rects=self._pack_rects(),
            boxes=self._pack_boxes(), triangles=_empty_triangles(),
            materials=materials, textures=textures,
            atlas=ImageAtlas(data=np.zeros(3, np.float32),
                             offset=np.zeros(1, np.int32),
                             width=np.ones(1, np.int32),
                             height=np.ones(1, np.int32)),
            background=np.asarray(self.background, np.float32),
            has_sphere_media=any(s["medium"] for s in self._spheres),
            has_box_media=any(b["medium"] for b in self._boxes),
        )

    def _pack_spheres(self) -> Spheres:
        rows = self._spheres
        n = _padded(len(rows))
        c0 = np.zeros((n, 3), np.float32)
        c1 = np.zeros((n, 3), np.float32)
        t0 = np.zeros(n, np.float32)
        t1 = np.ones(n, np.float32)
        r = np.full(n, 1.0, np.float32)
        mat = np.zeros(n, np.int32)
        act = np.zeros(n, bool)
        med = np.zeros(n, bool)
        nid = np.zeros(n, np.float32)
        uo = np.zeros(n, np.float32)
        for i, s in enumerate(rows):
            c0[i], c1[i], t0[i], t1[i] = s["c0"], s["c1"], s["t0"], s["t1"]
            r[i], mat[i], act[i] = s["r"], s["mat"], True
            med[i], nid[i], uo[i] = s["medium"], s["nid"], s["u_off"]
        return Spheres(center0=c0, center1=c1, time0=t0, time1=t1, radius=r,
                       mat_id=mat, active=act, medium=med,
                       neg_inv_density=nid, u_off=uo)

    def _pack_rects(self) -> Rects:
        rows = self._rects
        n = _padded(len(rows))
        axis = np.zeros(n, np.int32)
        a0 = np.zeros(n, np.float32)
        a1 = np.ones(n, np.float32)
        b0 = np.zeros(n, np.float32)
        b1 = np.ones(n, np.float32)
        k = np.zeros(n, np.float32)
        mat = np.zeros(n, np.int32)
        act = np.zeros(n, bool)
        for i, rc in enumerate(rows):
            axis[i], a0[i], a1[i] = rc["axis"], rc["a0"], rc["a1"]
            b0[i], b1[i], k[i] = rc["b0"], rc["b1"], rc["k"]
            mat[i], act[i] = rc["mat"], True
        return Rects(axis=axis, a0=a0, a1=a1, b0=b0, b1=b1, k=k, mat_id=mat,
                     active=act)

    def _pack_boxes(self) -> Boxes:
        rows = self._boxes
        n = _padded(len(rows))
        bmin = np.zeros((n, 3), np.float32)
        bmax = np.ones((n, 3), np.float32)
        cos = np.ones(n, np.float32)
        sin = np.zeros(n, np.float32)
        off = np.zeros((n, 3), np.float32)
        mat = np.zeros(n, np.int32)
        act = np.zeros(n, bool)
        med = np.zeros(n, bool)
        nid = np.zeros(n, np.float32)
        for i, b in enumerate(rows):
            bmin[i], bmax[i], cos[i], sin[i] = b["bmin"], b["bmax"], b["cos"], b["sin"]
            off[i], mat[i], act[i] = b["off"], b["mat"], True
            med[i], nid[i] = b["medium"], b["nid"]
        return Boxes(bmin=bmin, bmax=bmax, cos_t=cos, sin_t=sin, offset=off,
                     mat_id=mat, active=act, medium=med, neg_inv_density=nid)


def _empty_triangles() -> Triangles:
    """The padding-only triangle table the JAX builder packs for no
    triangles (degenerate-safe edges)."""
    n = _padded(0)
    z3 = np.zeros((n, 3), np.float32)
    z2 = np.zeros((n, 2), np.float32)
    e1, e2 = z3.copy(), z3.copy()
    e1[:, 0] = 1.0
    e2[:, 1] = 1.0
    return Triangles(
        v0=z3.copy(), e1=e1, e2=e2, n0=z3.copy(), n1=z3.copy(),
        n2=z3.copy(), uv0=z2.copy(), uv1=z2.copy(), uv2=z2.copy(),
        has_vn=np.zeros(n, bool), mat_id=np.zeros(n, np.int32),
        active=np.zeros(n, bool),
    )


def _padded(n: int) -> int:
    return max(_PAD, ((n + _PAD - 1) // _PAD) * _PAD)
