"""Host-side scene construction.

Counterpart of `raytracing_gpu_tpu/scene/builder.py`: solid, checker,
noise, turbulence, marble and image textures (an array, or a file decoded
by `io.images`, packed into one flat atlas); lambertian, metal, dielectric,
diffuse_light and isotropic materials; spheres and moving spheres
(rotate_y + translate baked, a negative radius for a hollow sphere),
axis-aligned rects (a pure translation offsets them, a rotation lowers them
to two triangles), boxes under rotate_y + translate, constant media in a box
or a sphere, triangles and triangle meshes (rotate_y, translate and scale
baked into the vertices).  `build()` packs the same numpy
tables, with the same padding, as the host snapshot that the JAX
`SceneBuilder.build` keeps (`_host_np`); beside them, as there, the XLA
engine's sphere and triangle BVHs (`accel.traverse`) above 64 primitives;
the kernel bake builds its own from the tables (`ops/cuda_trace.py`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np

from ..accel import bvh as bvh_mod
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
    TEX_IMAGE,
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
BVH_THRESHOLD = 64  # the XLA engine's BVHs above this many spheres, triangles


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


@dataclass
class SceneBuilder:
    background: tuple = SKY
    seed: int = 1984  # reference world seed (`scenes.h:30`)

    _tex: list = field(default_factory=list)
    _mat: list = field(default_factory=list)
    _spheres: list = field(default_factory=list)
    _rects: list = field(default_factory=list)
    _boxes: list = field(default_factory=list)
    _tris: list = field(default_factory=list)
    # columnar triangle blocks appended by mesh(): a 100k-triangle mesh
    # must not pay a dict per face
    _tri_blocks: list = field(default_factory=list)
    _images: list = field(default_factory=list)

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

    def image(self, img: Union[str, np.ndarray]) -> int:
        """Image texture from a path (decoded by `io.images.load_image`)
        or an (H, W, >=3) array in [0, 1]; the first three channels are
        kept."""
        if isinstance(img, str):
            from ..io import images as _images

            img = _images.load_image(img)
        img = np.asarray(img, np.float32)
        if img.ndim != 3 or img.shape[2] < 3:
            raise ValueError(
                f"image texture must be (H, W, >=3), got {img.shape}")
        self._images.append(np.ascontiguousarray(img[..., :3]))
        return self._add_tex(TEX_IMAGE, image_id=len(self._images) - 1)

    def _add_tex(self, kind, c1=None, c2=None, scale=1.0,
                 image_id=-1) -> int:
        self._tex.append(dict(
            kind=kind, c1=_v3(c1 if c1 is not None else (0, 0, 0)),
            c2=_v3(c2 if c2 is not None else (0, 0, 0)), scale=float(scale),
            image_id=int(image_id)))
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
        translation offsets the bounds; a rotation lowers the rect to two
        triangles carrying its uv parameterization and rotated normal."""
        axis = {"yz": RECT_YZ, "xz": RECT_XZ, "xy": RECT_XY}[orientation]
        tx, ty, tz = (float(x) for x in np.asarray(translate, np.float64))
        if rotate_y % 360.0 == 0.0:
            da, db, dk = {RECT_YZ: (ty, tz, tx), RECT_XZ: (tx, tz, ty),
                          RECT_XY: (tx, ty, tz)}[axis]
            self._rects.append(
                dict(axis=axis, a0=float(a0) + da, a1=float(a1) + da,
                     b0=float(b0) + db, b1=float(b1) + db, k=float(k) + dk,
                     mat=mat))
            return

        # uv corners follow u = (a - a0) / (a1 - a0), v = (b - b0) / (b1 - b0)
        def pt(a, b):
            p = {RECT_YZ: (k, a, b), RECT_XZ: (a, k, b),
                 RECT_XY: (a, b, k)}[axis]
            return _rot_y(_v3(p), rotate_y) + _v3(translate)

        p00, p10 = pt(a0, b0), pt(a1, b0)
        p11, p01 = pt(a1, b1), pt(a0, b1)
        n = _rot_y(np.eye(3, dtype=np.float32)[axis], rotate_y)
        self.triangle(p00, p11, p10, mat, uv0=(0, 0), uv1=(1, 1), uv2=(1, 0),
                      normals=(n, n, n))
        self.triangle(p00, p01, p11, mat, uv0=(0, 0), uv1=(0, 1), uv2=(1, 1),
                      normals=(n, n, n))

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

    def triangle(self, v0, v1, v2, mat: int, uv0=(0, 0), uv1=(0, 0),
                 uv2=(0, 0), normals: Optional[Sequence] = None) -> None:
        """reference `triangle.h` ctors, with or without vertex normals;
        without them every vertex carries the face normal
        cross(v2 - v0, v1 - v0), the reference's order."""
        v0, v1, v2 = _v3(v0), _v3(v1), _v3(v2)
        if normals is None:
            n0 = n1 = n2 = np.cross(v2 - v0, v1 - v0)
            has_vn = False
        else:
            n0, n1, n2 = (_v3(x) for x in normals)
            has_vn = True
        self._tris.append(dict(
            v0=v0, e1=v1 - v0, e2=v2 - v0, n0=n0, n1=n1, n2=n2,
            uv0=np.asarray(uv0, np.float32), uv1=np.asarray(uv1, np.float32),
            uv2=np.asarray(uv2, np.float32), has_vn=has_vn, mat=mat))

    def mesh(self, vertices: np.ndarray, faces: np.ndarray, mat: int,
             uvs: Optional[np.ndarray] = None,
             normals: Optional[np.ndarray] = None,
             rotate_y: float = 0.0, translate=(0.0, 0.0, 0.0),
             scale: float = 1.0) -> None:
        """Triangle mesh (`triangle_mesh.h:147-204`): the vertices scaled,
        rotated about y and translated, the normals rotated, one columnar
        block per call."""
        vertices = np.asarray(vertices, np.float32) * scale
        faces = np.asarray(faces, np.int64)
        if rotate_y:
            vertices = _rot_y_rows(vertices, rotate_y)
        vertices = vertices + _v3(translate)
        i, j, k = faces[:, 0], faces[:, 1], faces[:, 2]
        v0 = vertices[i]
        e1 = vertices[j] - v0
        e2 = vertices[k] - v0
        if normals is None:
            n0 = n1 = n2 = np.cross(e2, e1).astype(np.float32)
            has_vn = np.zeros(len(faces), bool)
        else:
            normals = np.asarray(normals, np.float32)
            if rotate_y:
                normals = _rot_y_rows(normals, rotate_y)
            n0, n1, n2 = normals[i], normals[j], normals[k]
            has_vn = np.ones(len(faces), bool)
        z2 = np.zeros((len(faces), 2), np.float32)
        self._tri_blocks.append(dict(
            v0=v0, e1=e1, e2=e2, n0=n0, n1=n1, n2=n2,
            uv0=uvs[i].astype(np.float32) if uvs is not None else z2,
            uv1=uvs[j].astype(np.float32) if uvs is not None else z2,
            uv2=uvs[k].astype(np.float32) if uvs is not None else z2,
            has_vn=has_vn, mat=np.full(len(faces), mat, np.int32)))

    def _tri_columns(self) -> dict:
        """Every triangle as one columnar dict, in insertion order: the
        single triangles first, then the mesh blocks (None per column when
        there are none)."""
        cols = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                "has_vn", "mat")
        blocks = []
        if self._tris:
            blocks.append({c: np.stack([t[c] for t in self._tris])
                           for c in cols if c not in ("has_vn", "mat")})
            blocks[0]["has_vn"] = np.asarray(
                [t["has_vn"] for t in self._tris], bool)
            blocks[0]["mat"] = np.asarray([t["mat"] for t in self._tris],
                                          np.int32)
        blocks.extend(self._tri_blocks)
        if not blocks:
            return {c: None for c in cols}
        out = {c: np.concatenate([b[c] for b in blocks]) for c in cols}
        for c in cols:
            if c not in ("has_vn", "mat"):
                out[c] = out[c].astype(np.float32)
        return out

    @property
    def n_tris(self) -> int:
        return len(self._tris) + sum(len(b["mat"]) for b in self._tri_blocks)

    # -- packing -----------------------------------------------------------

    def build(self) -> Scene:
        """Pack everything into the Scene tables (host numpy arrays), with
        a triangle BVH above BVH_THRESHOLD triangles and a sphere BVH above
        BVH_THRESHOLD spheres, as the JAX builder's `bvh="auto"` gives
        them: the XLA engine's BVHs (`accel.traverse`); the kernel bake
        builds its own."""
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
        tri_cols = self._tri_columns()
        tri_bvh = (bvh_mod.build_triangle_bvh(tri_cols)
                   if self.n_tris > BVH_THRESHOLD else None)
        sph_bvh = (bvh_mod.build_sphere_bvh(self._spheres)
                   if len(self._spheres) > BVH_THRESHOLD else None)
        return Scene(
            spheres=self._pack_spheres(), rects=self._pack_rects(),
            boxes=self._pack_boxes(),
            triangles=_pack_tris(tri_cols),
            materials=materials, textures=textures,
            atlas=self._pack_atlas(),
            background=np.asarray(self.background, np.float32),
            tri_bvh=tri_bvh, sphere_bvh=sph_bvh,
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


    def _pack_atlas(self) -> ImageAtlas:
        """Every image in one flat float32 rgb array, with each image's
        first texel, width and height (`_pack_atlas`, the reference's
        `make_image`, `texture.h:166-203`); one black texel of a 1 x 1
        image when none is bound."""
        if not self._images:
            return ImageAtlas(data=np.zeros(3, np.float32),
                              offset=np.zeros(1, np.int32),
                              width=np.ones(1, np.int32),
                              height=np.ones(1, np.int32))
        sizes = [img.shape[0] * img.shape[1] for img in self._images]
        return ImageAtlas(
            data=np.concatenate([img.reshape(-1) for img in self._images]
                                ).astype(np.float32),
            offset=np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(
                np.int32),
            width=np.asarray([img.shape[1] for img in self._images],
                             np.int32),
            height=np.asarray([img.shape[0] for img in self._images],
                              np.int32))


def _pack_tris(cols: dict) -> Triangles:
    """The triangle table, padded as the JAX builder pads it: pad rows have
    the degenerate-safe edges e1 = x, e2 = y and are inactive."""
    k = 0 if cols["mat"] is None else len(cols["mat"])
    n = _padded(k)
    z3 = np.zeros((n, 3), np.float32)
    z2 = np.zeros((n, 2), np.float32)
    t = dict(v0=z3, e1=z3.copy(), e2=z3.copy(), n0=z3.copy(), n1=z3.copy(),
             n2=z3.copy(), uv0=z2, uv1=z2.copy(), uv2=z2.copy(),
             has_vn=np.zeros(n, bool), mat_id=np.zeros(n, np.int32),
             active=np.zeros(n, bool))
    t["e1"][:, 0] = 1.0
    t["e2"][:, 1] = 1.0
    if k:
        for c in ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                  "has_vn"):
            t[c][:k] = cols[c]
        t["mat_id"][:k] = cols["mat"]
        t["active"][:k] = True
    return Triangles(**t)


def _rot_y_rows(p: np.ndarray, degrees: float) -> np.ndarray:
    """Rotate (N, 3) float32 rows about y as `_rot_y` rotates one point, in
    float32 as the JAX builder's mesh() does."""
    th = math.radians(degrees)
    c, s = math.cos(th), math.sin(th)
    x, y, z = p[:, 0].copy(), p[:, 1], p[:, 2].copy()
    return np.stack((c * x + s * z, y, -s * x + c * z), axis=-1)


def _padded(n: int) -> int:
    return max(_PAD, ((n + _PAD - 1) // _PAD) * _PAD)
