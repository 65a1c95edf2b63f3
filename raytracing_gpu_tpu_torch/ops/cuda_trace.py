"""Host side of the path-tracing kernels, and their plain PyTorch versions.

Counterpart of `raytracing_gpu_tpu/ops/pallas_trace.py`, in three
functions:

- forward radiance (`PallasTracer.trace_pixels` with the camera rays made
  inside the kernel, `PallasTracer.__call__` on ray planes): axis-aligned
  rects, boxes under rotate_y + translate, spheres (static, moving, hollow)
  in a dense loop up to 64 and through a threaded sphere BVH above,
  triangles through a threaded triangle BVH, up to 16 constant media in a
  sphere or a box; lambertian, metal, dielectric, diffuse_light and
  isotropic materials; solid, checker, noise, turbulence and marble albedo;
  russian roulette and the shutter time; not image textures, whose atlas
  the shading reads (`supports_forward`, as the JAX kernel refuses them);
- the record walk (`PallasTracer.walk_packed_pixels` on camera rays,
  `walk_packed` and `walk` on ray planes), over the same features and
  image textures: the packed plane, the hit-point planes when a checker
  or perlin texture needs them (`need_p`), and the uv planes when an image
  texture does (`need_uv`);
- the pure closest hit of the wavefront drivers (`PallasTracer.hit`), for
  scenes without media, with the triangle tier over the packed geometry.

The kernels are `csrc/megakernel.cuh` and `csrc/hit.cu`;
`trace_pixels_reference`, `trace_rays_reference`,
`walk_packed_pixels_reference`, `walk_packed_reference` and
`hit_reference` are the same functions in plain PyTorch, written op for op
in the kernels' order so that the two round alike.  The plain megakernel
versions walk the sphere BVH lane by lane as the kernels do
(`sphere_walk_reference`): a ray that grazes a node's box can round out of
it and miss a sphere that a dense loop over the rows would find.
`hit_reference` tests every sphere row densely (a pad row of the BVH's
leaf-contiguous table has radius 0 and never hits).  Triangles they
walk lane by lane as the kernels do (`tri_walk_reference`), so that rays
through a shared edge keep the same one of its two triangles.

Not ported (`unported_feature` names it): more than 16 media.

The random numbers are the JAX kernel's, bit for bit: a PCG hash of the
lane index within the call mixed with an int32 seed, then one more hash per
draw site (`pcg_hash`, `uniform`).  The plain versions do their uint32
arithmetic in int64 and mask after every multiply and add, because torch's
uint32 dtype lacks those operations on the CPU.

`Tracer` holds a baked scene on one device.  On a CUDA device its
`trace_pixels`, `__call__`, `walk_packed_pixels`, `walk_packed` and `hit`
launch the kernels, `bind_chunk` the forward kernel once for a whole
sample chunk and `bind_record_chunk` the record kernel once for a whole
training chunk (a failed build or launch raises); on the CPU they run the
plain versions (`trace_chunk_reference` and `walk_chunk_reference` for
the chunks).  `Tracer.launches` (one wave), `Tracer.chunk_launches`,
`Tracer.record_launches` (one wave), `Tracer.record_chunk_launches`,
`Tracer.ray_launches` (both ray-plane entries; `walk_ray_launches` the
record mode's share) and `Tracer.hit_launches` count the launches of each
entry, so a caller can show that a render went through it;
`launch_counts` reads them by C entry and `reset_launch_counts` sets them
to 0.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..accel import bvh as bvh_mod
from ..scene import perlin
from ..scene import types as st
from . import build

_M32 = 0xFFFFFFFF
_SEED_MIX = 0x85EBCA6B          # seed mixer (pallas_trace.py:906)
_SALT_MUL = 0x9E3779B9          # per-salt offset (pallas_trace.py:677)
_DRAW_MUL = 0x68E31DA4          # per-bounce draw window (pallas_trace.py:1295)
_CAM_DRAW = (0x7F4A7C15 * _DRAW_MUL) & _M32  # camera window (:1585)
_WAVE_MULTIPLIERS = (7919, 104729, 1299709, 15485863)


def _f32(x: float) -> float:
    """`x` rounded to float32: the value a JAX weak-typed float32 constant
    takes, so comparisons and products agree whatever precision torch uses
    for a Python scalar."""
    return float(np.float32(x))


BIG = _f32(1e30)
_EPS = _f32(1e-12)
_TWO_PI = _f32(2.0 * math.pi)
_DEGEN = _f32(1e-8)
_NORM_FLOOR = _f32(1e-20)
_THIRD = _f32(1.0 / 3.0)
_LEN_FLOOR = _f32(1e-30)
_RR_FLOOR = _f32(0.05)
# the hit kernel's sphere uv (pallas_trace.py:2197-2201, `_atan2_poly`)
_PI = _f32(math.pi)
_HALF_PI = _f32(math.pi / 2)
_INV_TWO_PI = _f32(1.0 / (2.0 * math.pi))
_INV_PI = _f32(1.0 / math.pi)
_ATAN_COEFFS = tuple(_f32(c) for c in (0.9998660, -0.3302995, 0.1801410,
                                       -0.0851330, 0.0208351))
_HI_FLOOR = _f32(1e-30)

# Kernel record layouts (csrc/megakernel.cuh reads these columns).  Every
# record ends in, or holds at a fixed offset, the same 12-column shading
# block, which is columns 9-20 of the JAX package's sphere rows
# (`_SPH_KIND`..`_SPH_MAT`, pallas_trace.py:175-177).
SH_KIND, SH_C1, SH_C2, SH_SCALE, SH_FUZZ, SH_IR, SH_TEXK, SH_MAT = (
    0, 1, 4, 7, 8, 9, 10, 11)
SH_COLS = 12
RECT_COLS, RECT_SH = 18, 6     # axis a0 a1 b0 b1 k | shading
BOX_COLS, BOX_SH = 24, 12      # bmin xyz, bmax xyz, cos sin, off xyz, pad | shading
SPHERE_COLS, SPHERE_SH = 24, 9  # c0 xyz, c1 xyz, t0 t1 radius | shading | u_off pad pad
MEDIUM_COLS, MEDIUM_SH = 24, 12
# medium record: nid, then a sphere's c0 xyz, c1 - c0 xyz, t0,
# 1 / (t1 - t0), radius**2 (3 pad), or a box's bmin xyz, bmax xyz, cos sin,
# off xyz; then the shading block.  Sphere media come first, then box
# media, in the JAX kernel's order (`:1303`).
MAX_SPHERES = 64   # the dense loop; a sphere BVH above (`_SPH_BVH_MIN`, :149)
SPH_LEAF_K = 8     # sphere rows per BVH leaf (`_SPH_LEAF_K`, :150)
HIT_NODE_COLS = 23  # bounds | leaf start | 8 octant (hit, miss) link pairs
NODE_REC_COLS = 8   # a kernel's node record: lo xyz, first | hi xyz, count
TRI_SLOT_COLS = 12  # a hit-tier slot on the device: v0 e1 e2, 3 zeros
MAX_MEDIA = 16     # RNG salts per bounce for free paths (`_MAX_MEDIA`, :178)
# triangle rows of the megakernel (`_TRI_*`, pallas_trace.py:128-133): v0 e1
# e2 | n0 n1 n2 | uv0 uv1 uv2 | kind fuzz ir mat | c1 c2 scale texk | pad
TRI_V0, TRI_N0, TRI_UV0 = 0, 9, 18
TRI_KIND, TRI_FUZZ, TRI_IR, TRI_MAT = 24, 25, 26, 27
TRI_C1, TRI_C2, TRI_SCALE, TRI_TEXK = 28, 31, 34, 35
TRI_COLS = 40
TRI_LEAF_K = 4      # triangle rows per megakernel BVH leaf (`_TRI_LEAF_K`)
HIT_TRI_LEAF_K = 28  # hit-tier slots per leaf: 2 rows of 14 (:155-156)
TRI_DET = _f32(1e-7)  # Moller-Trumbore determinant cut (:1208-1214)
HIT_BIT, CONT_BIT, MISS_BIT = 1 << 16, 1 << 17, 1 << 18  # packed record word
FRONT_BIT, TRI_BIT, SPH_BIT = 1 << 19, 1 << 20, 1 << 21  # hit kernel's word
# what a launch's kernel instantiation covers (csrc/megakernel.cuh kFeat*)
FEAT_SPHERES, FEAT_MEDIA, FEAT_SPHERE_BVH = 1, 2, 4
FEAT_CHECKER, FEAT_PERLIN, FEAT_TRI_BVH = 8, 16, 32
_PERLIN_KINDS = {st.TEX_NOISE, st.TEX_TURB, st.TEX_MARBLE}
_POSITION_KINDS = {st.TEX_CHECKER} | _PERLIN_KINDS


# --------------------------------------------------------------------------
# scene bake
# --------------------------------------------------------------------------


class SceneBake(NamedTuple):
    """Host snapshot of what the kernels read, as `pallas_trace.bake_scene`
    makes it: one dict of Python floats per active rect, box and medium,
    with the JAX bake's keys; the sphere table in the JAX column layout,
    reordered leaf-contiguous when it has a BVH; the sphere BVH (M = 0
    nodes without one); the triangles in two tiers (`_bake_triangles`);
    and the background."""

    rects: list
    boxes: list
    sphere_table: np.ndarray  # (S, 24) float32
    sphere_media: list
    box_media: list
    background: tuple
    sph_nodes: np.ndarray      # (M, 6) float32 node bounds: lo xyz, hi xyz
    sph_links: np.ndarray      # (M, 2) int32 preorder (hit, miss) links
    sph_start: np.ndarray      # (M, 1) int32 a leaf's first row, else -1
    sph_hit_nodes: np.ndarray  # (M, 23) float32, HIT_NODE_COLS
    # the megakernel's triangles: (T, TRI_COLS) float32 rows, leaf-contiguous
    # in leaves of TRI_LEAF_K, the original triangle id of each row (-1 on
    # a pad row), and their BVH as the sphere BVH's arrays
    tri_table: np.ndarray      # (T, 40) float32
    tri_ids: np.ndarray        # (T,) int32
    tri_nodes: np.ndarray      # (Mt, 6) float32
    tri_links: np.ndarray      # (Mt, 2) int32
    tri_start: np.ndarray      # (Mt, 1) int32
    # the hit kernel's triangle tier: geometry only (v0 e1 e2) per slot,
    # leaf-contiguous in leaves of HIT_TRI_LEAF_K, the slot -> original
    # triangle id map (-1 on a pad slot), and nodes in the HIT_NODE_COLS
    # layout with a leaf's first slot in column 6
    tri_geom: np.ndarray       # (Sl, 9) float32
    tri_perm: np.ndarray       # (Sl,) int32
    tri_hit_nodes: np.ndarray  # (Mh, 23) float32

    @property
    def jax_tri_stream(self) -> bool:
        """The JAX package's routing predicate for meshes, kept as such: its
        bake streams the triangle table from HBM (`tri_mode == "stream"`,
        `_bake_triangles`, pallas_trace.py:482-490) when 512 bytes a
        triangle, or 512 bytes a row and a node of the leaf-4 table, exceed
        8 MiB of VMEM; `compile_renderer` then sends the scene to a
        wavefront.  A threshold measured on the TPU, kept until it is
        derived again on the H100; this port has one triangle tier."""
        n_tris = int((self.tri_ids >= 0).sum())
        budget = 8 * 2**20
        return n_tris > 0 and (
            n_tris * 512 > budget
            or (len(self.tri_table) + len(self.tri_nodes)) * 512 > budget)

    def sph_leaf_count(self) -> np.ndarray:
        """(M,) int32 rows each sphere-BVH node's leaf tests: up to its
        last row of radius != 0 (pads, radius 0, sit at a leaf's tail and
        never hit); 0 on an internal node."""
        return _leaf_counts(self.sphere_table[:, 8] != 0, self.sph_start,
                            SPH_LEAF_K)

    def tri_leaf_count(self) -> np.ndarray:
        """(Mt,) int32 real rows of each megakernel triangle leaf
        (`tri_ids >= 0`); 0 on an internal node."""
        return _leaf_counts(self.tri_ids >= 0, self.tri_start, TRI_LEAF_K)

    def tri_hit_leaf_count(self) -> np.ndarray:
        """(Mh,) int32 real slots of each hit-tier leaf (`tri_perm >= 0`);
        0 on an internal node."""
        return _leaf_counts(self.tri_perm >= 0,
                            self.tri_hit_nodes[:, 6].astype(np.int64),
                            HIT_TRI_LEAF_K)

    def world_bounds(self) -> tuple:
        """(lo, hi) float32 (3,) for the wavefront's morton keys
        (pallas_trace.py:2388-2404): the triangle BVH's root box when a
        mesh exists, else the union of the sphere rows' bounds (pad rows
        included, as the JAX tracer takes them), else the cube [-1, 1]."""
        if len(self.tri_nodes):
            return self.tri_nodes[0, :3].copy(), self.tri_nodes[0, 3:6].copy()
        tb = self.sphere_table
        if not len(tb):
            return (np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32))
        c0, c1, r = tb[:, 0:3], tb[:, 3:6], np.abs(tb[:, 8:9])
        return ((np.minimum(c0, c1) - r).min(0),
                (np.maximum(c0, c1) + r).max(0))

    def rect_table(self) -> np.ndarray:
        """(R, RECT_COLS) float32 records for the kernel."""
        t = np.zeros((len(self.rects), RECT_COLS), np.float32)
        for i, r in enumerate(self.rects):
            t[i, :RECT_SH] = (r["axis"], r["a0"], r["a1"], r["b0"], r["b1"],
                              r["k"])
            t[i, RECT_SH:] = _shading_row(r)
        return t

    def box_table(self) -> np.ndarray:
        """(B, BOX_COLS) float32 records for the kernel."""
        t = np.zeros((len(self.boxes), BOX_COLS), np.float32)
        for i, b in enumerate(self.boxes):
            t[i, :11] = _box_geometry(b)
            t[i, BOX_SH:] = _shading_row(b)
        return t

    def media_table(self) -> np.ndarray:
        """(M, MEDIUM_COLS) float32 records for the kernel: sphere media,
        then box media.  The sphere's constants are the JAX kernel's Python
        doubles (`:1311-1323`) rounded once to float32."""
        t = np.zeros((len(self.sphere_media) + len(self.box_media),
                      MEDIUM_COLS), np.float32)
        for i, m in enumerate(self.sphere_media):
            span = m["t1"] - m["t0"]
            span = span if abs(span) > 1e-12 else 1.0
            c0, c1 = m["center0"], m["center1"]
            t[i, 1:10] = (*c0, *(b - a for a, b in zip(c0, c1)), m["t0"],
                          1.0 / span, m["radius"] * m["radius"])
        for i, m in enumerate(self.box_media, start=len(self.sphere_media)):
            t[i, 1:12] = _box_geometry(m)
        for i, m in enumerate(self.sphere_media + self.box_media):
            t[i, 0] = m["nid"]
            t[i, MEDIUM_SH:] = _shading_row(m)
        return t

    def shading_table(self) -> np.ndarray:
        """(1 + R + B + S + M + T, 12) float32: a default row (what a miss
        carries: everything 0 but ir = 1), then every primitive's shading
        block in the closest-hit order, media and then the triangle rows
        last.  The plain versions carry an index into it."""
        rows = [np.array([0] * SH_IR + [1, 0, 0], np.float32)[None]]
        rows += [self.rect_table()[:, RECT_SH:], self.box_table()[:, BOX_SH:],
                 self.sphere_table[:, SPHERE_SH:SPHERE_SH + SH_COLS],
                 self.media_table()[:, MEDIUM_SH:],
                 tri_shading(self.tri_table)]
        return np.concatenate(rows).astype(np.float32)

    def texture_kinds(self) -> set:
        """The texture kinds the kernel evaluates (`tex_kinds`, :860-866)."""
        return self._kinds("texk", SH_TEXK)

    @property
    def need_p(self) -> bool:
        """Whether the record walk writes the hit-point planes: a checker or
        perlin texture is bound (`PallasTracer.need_p`,
        pallas_trace.py:2411-2413)."""
        return bool(self.texture_kinds() & _POSITION_KINDS)

    @property
    def need_uv(self) -> bool:
        """Whether the record walk writes the uv planes: an image texture
        is bound (`PallasTracer.need_uv`, pallas_trace.py:2413)."""
        return st.TEX_IMAGE in self.texture_kinds()

    def material_kinds(self) -> set:
        return self._kinds("kind", SH_KIND)

    def _kinds(self, key: str, col: int) -> set:
        prims = self.rects + self.boxes + self.sphere_media + self.box_media
        tris = tri_shading(self.tri_table[self.tri_ids >= 0])
        return ({int(p[key]) for p in prims}
                | {int(k) for k in self.sphere_table[:, SPHERE_SH + col]}
                | {int(k) for k in tris[:, col]})

    def features(self) -> int:
        """The FEAT_* bits of the forward kernel instantiation this bake
        needs; perlin textures take the instantiation that also has the
        checker.  Spheres are a dense loop or a BVH walk, never both."""
        if len(self.sph_nodes):
            f = FEAT_SPHERE_BVH
        else:
            f = FEAT_SPHERES if len(self.sphere_table) else 0
        if self.sphere_media or self.box_media:
            f |= FEAT_MEDIA
        if len(self.tri_nodes):
            f |= FEAT_TRI_BVH
        kinds = self.texture_kinds()
        if kinds & _PERLIN_KINDS:
            f |= FEAT_CHECKER | FEAT_PERLIN
        elif st.TEX_CHECKER in kinds:
            f |= FEAT_CHECKER
        return f


def tri_shading(rows: np.ndarray) -> np.ndarray:
    """(T, 12) float32: the shading block (SH_* order) of each triangle row,
    read from its kind, fuzz, ir, mat, c1, c2, scale and texk columns."""
    return np.concatenate(
        [rows[:, TRI_KIND:TRI_KIND + 1], rows[:, TRI_C1:TRI_C1 + 3],
         rows[:, TRI_C2:TRI_C2 + 3], rows[:, TRI_SCALE:TRI_SCALE + 1],
         rows[:, TRI_FUZZ:TRI_FUZZ + 1], rows[:, TRI_IR:TRI_IR + 1],
         rows[:, TRI_TEXK:TRI_TEXK + 1], rows[:, TRI_MAT:TRI_MAT + 1]],
        axis=1).astype(np.float32)


def _shading_row(prim: dict) -> tuple:
    return (prim["kind"], *prim["c1"], *prim["c2"], prim["scale"],
            prim["fuzz"], prim["ir"], prim["texk"], prim["mat"])


def _box_geometry(b: dict) -> tuple:
    return (*b["bmin"], *b["bmax"], b["cos"], b["sin"], *b["off"])


def _mat_shading(scene: st.Scene, mat_id: int) -> dict:
    """(kind, texture kind/colors/scale, fuzz, ir) host scalars for a
    material, as `pallas_trace._mat_shading`."""
    mats, texs = scene.materials, scene.textures
    tex = int(mats.tex_id[mat_id])
    return dict(kind=int(mats.kind[mat_id]),
                c1=tuple(float(x) for x in texs.c1[tex]),
                c2=tuple(float(x) for x in texs.c2[tex]),
                texk=int(texs.kind[tex]), scale=float(texs.scale[tex]),
                fuzz=float(mats.fuzz[mat_id]), ir=float(mats.ir[mat_id]),
                mat=int(mat_id))


def bake_scene(scene: st.Scene) -> SceneBake:
    """Snapshot the active primitives, as `pallas_trace.bake_scene`
    (`:253-344`) does: above 64 sphere rows the table gets a BVH of leaves
    of 8 and is reordered leaf-contiguous; the triangles are baked by
    `_bake_triangles`."""
    rc = scene.rects
    rects = [dict(axis=int(rc.axis[i]), a0=float(rc.a0[i]),
                  a1=float(rc.a1[i]), b0=float(rc.b0[i]), b1=float(rc.b1[i]),
                  k=float(rc.k[i]), **_mat_shading(scene, int(rc.mat_id[i])))
             for i in range(len(rc.axis)) if rc.active[i]]
    bx = scene.boxes
    boxes, box_media = [], []
    for i in range(len(bx.cos_t)):
        if not bx.active[i]:
            continue
        row = dict(bmin=tuple(float(x) for x in bx.bmin[i]),
                   bmax=tuple(float(x) for x in bx.bmax[i]),
                   cos=float(bx.cos_t[i]), sin=float(bx.sin_t[i]),
                   off=tuple(float(x) for x in bx.offset[i]),
                   **_mat_shading(scene, int(bx.mat_id[i])))
        if bx.medium[i]:
            row["nid"] = float(bx.neg_inv_density[i])
            box_media.append(row)
        else:
            boxes.append(row)
    sp = scene.spheres
    rows, sphere_media = [], []
    for i in range(len(sp.radius)):
        if not sp.active[i]:
            continue
        sh = _mat_shading(scene, int(sp.mat_id[i]))
        c0, c1 = sp.center0[i], sp.center1[i]
        if sp.medium[i]:
            # the JAX bake names the centers c0/c1, and c1 is also the
            # texture colour there (pallas_trace.py:300-307 cannot build
            # this dict); here the centers are center0/center1
            sphere_media.append(dict(
                center0=tuple(float(x) for x in c0),
                center1=tuple(float(x) for x in c1),
                t0=float(sp.time0[i]), t1=float(sp.time1[i]),
                radius=float(sp.radius[i]), nid=float(sp.neg_inv_density[i]),
                **sh))
            continue
        rows.append([*c0, *c1, sp.time0[i], sp.time1[i], sp.radius[i],
                     *_shading_row(sh), sp.u_off[i], 0.0, 0.0])
    table = (np.asarray(rows, np.float32) if rows
             else np.zeros((0, SPHERE_COLS), np.float32))
    sph_nodes = np.zeros((0, 6), np.float32)
    sph_links = np.zeros((0, 2), np.int32)
    sph_start = np.full((0, 1), -1, np.int32)
    sph_hit_nodes = np.zeros((0, HIT_NODE_COLS), np.float32)
    if len(table) > MAX_SPHERES:
        # moving spheres: the union of the t0 and t1 boxes (moving_sphere.h)
        c0s, c1s, rr = table[:, 0:3], table[:, 3:6], np.abs(table[:, 8:9])
        bvh = bvh_mod.build(np.minimum(c0s, c1s) - rr,
                            np.maximum(c0s, c1s) + rr, leaf_size=SPH_LEAF_K)
        table, sph_nodes, sph_links, sph_start = _leaf_contiguous(
            table, bvh, SPH_LEAF_K)
        sph_hit_nodes = np.concatenate(
            [sph_nodes, sph_start.astype(np.float32), _octant_links(bvh)],
            axis=1)
    return SceneBake(rects=rects, boxes=boxes, sphere_table=table,
                     sphere_media=sphere_media, box_media=box_media,
                     background=tuple(float(x) for x in scene.background),
                     sph_nodes=sph_nodes, sph_links=sph_links,
                     sph_start=sph_start, sph_hit_nodes=sph_hit_nodes,
                     **_bake_triangles(scene))


def _bake_triangles(scene: st.Scene) -> dict:
    """The triangle fields of SceneBake (`pallas_trace._bake_triangles`,
    :402-505, and `_bake_tri_packed`, :508-593), in one tier each:

    - the megakernel's denormalized rows (TRI_COLS; the face normal
      cross(e2, e1) in all three normal slots when the mesh has none),
      leaf-contiguous in leaves of TRI_LEAF_K under a BVH of their own;
      the JAX bake's resident table, whatever the mesh's size (its HBM
      streaming tier has no counterpart in device memory);
    - the hit kernel's packed geometry, leaf-contiguous in leaves of
      HIT_TRI_LEAF_K (the JAX bake's two rows of 14, without its escalation
      or row boxes), with the slot -> triangle id map and octant-threaded
      nodes.

    Both BVHs bound each triangle by its vertices, a flat extent padded by
    BBOX_PAD (:466-474)."""
    tr = scene.triangles
    act = np.asarray(tr.active)
    if not act.any():
        return dict(tri_table=np.zeros((0, TRI_COLS), np.float32),
                    tri_ids=np.zeros(0, np.int32),
                    tri_nodes=np.zeros((0, 6), np.float32),
                    tri_links=np.zeros((0, 2), np.int32),
                    tri_start=np.full((0, 1), -1, np.int32),
                    tri_geom=np.zeros((0, 9), np.float32),
                    tri_perm=np.zeros(0, np.int32),
                    tri_hit_nodes=np.zeros((0, HIT_NODE_COLS), np.float32))
    rows = np.zeros((act.shape[0], TRI_COLS), np.float32)
    v0 = np.asarray(tr.v0, np.float32)
    e1 = np.asarray(tr.e1, np.float32)
    e2 = np.asarray(tr.e2, np.float32)
    rows[:, 0:3], rows[:, 3:6], rows[:, 6:9] = v0, e1, e2
    has_vn = np.asarray(tr.has_vn)[:, None]
    face_n = np.cross(e2, e1).astype(np.float32)
    for k, nn in enumerate((tr.n0, tr.n1, tr.n2)):
        rows[:, TRI_N0 + 3 * k:TRI_N0 + 3 * k + 3] = np.where(
            has_vn, np.asarray(nn, np.float32), face_n)
    for k, uv in enumerate((tr.uv0, tr.uv1, tr.uv2)):
        rows[:, TRI_UV0 + 2 * k:TRI_UV0 + 2 * k + 2] = np.asarray(uv,
                                                                 np.float32)
    mat_ids = np.asarray(tr.mat_id)
    mats, texs = scene.materials, scene.textures
    tex = np.asarray(mats.tex_id)[mat_ids]
    rows[:, TRI_KIND] = np.asarray(mats.kind, np.float32)[mat_ids]
    rows[:, TRI_FUZZ] = np.asarray(mats.fuzz, np.float32)[mat_ids]
    rows[:, TRI_IR] = np.asarray(mats.ir, np.float32)[mat_ids]
    rows[:, TRI_MAT] = mat_ids.astype(np.float32)
    rows[:, TRI_C1:TRI_C1 + 3] = np.asarray(texs.c1, np.float32)[tex]
    rows[:, TRI_C2:TRI_C2 + 3] = np.asarray(texs.c2, np.float32)[tex]
    rows[:, TRI_SCALE] = np.asarray(texs.scale, np.float32)[tex]
    rows[:, TRI_TEXK] = np.asarray(texs.kind, np.float32)[tex]

    keep = np.nonzero(act)[0]
    v1, v2 = v0 + e1, v0 + e2
    bmin = np.minimum(np.minimum(v0, v1), v2)
    bmax = np.maximum(np.maximum(v0, v1), v2)
    flat = (bmax - bmin) < 1e-6
    bmin = np.where(flat, bmin - bvh_mod.BBOX_PAD, bmin)[keep]
    bmax = np.where(flat, bmax + bvh_mod.BBOX_PAD, bmax)[keep]

    # each row carries its id + 1 through the reorder (a pad row is all 0;
    # ids stay far below 2**24, exact in float32)
    idcol = (keep + 1).astype(np.float32)[:, None]
    bvh = bvh_mod.build(bmin, bmax, leaf_size=TRI_LEAF_K)
    table, nodes, links, start = _leaf_contiguous(
        np.concatenate([rows[keep], idcol], axis=1), bvh, TRI_LEAF_K)
    tri_ids = table[:, -1].astype(np.int64) - 1

    hbvh = bvh_mod.build(bmin, bmax, leaf_size=HIT_TRI_LEAF_K)
    geom, _, _, hstart = _leaf_contiguous(
        np.concatenate([rows[keep, :9], idcol], axis=1), hbvh,
        HIT_TRI_LEAF_K)
    perm = geom[:, 9].astype(np.int64) - 1
    hit_nodes = np.concatenate(
        [np.asarray(hbvh.node_min, np.float32),
         np.asarray(hbvh.node_max, np.float32),
         hstart.astype(np.float32), _octant_links(hbvh)], axis=1)
    return dict(tri_table=np.ascontiguousarray(table[:, :TRI_COLS]),
                tri_ids=tri_ids.astype(np.int32), tri_nodes=nodes,
                tri_links=links, tri_start=start,
                tri_geom=np.ascontiguousarray(geom[:, :9]),
                tri_perm=perm.astype(np.int32), tri_hit_nodes=hit_nodes)


def _leaf_contiguous(rows: np.ndarray, bvh: bvh_mod.FlatBVH, leaf_k: int):
    """Reorder primitive rows so each BVH leaf owns `leaf_k` contiguous rows
    (`pallas_trace._leaf_contiguous`, :372-400): returns (table, nodes
    (M, 6), links (M, 2), start (M, 1)); table row `start[i] + k` is leaf
    i's k-th primitive, and the slots past a leaf's count hold an all-zero
    row, which no sphere test accepts (radius 0)."""
    lp = np.asarray(bvh.leaf_prims)
    m = lp.shape[0]
    start = np.full((m, 1), -1, np.int32)
    leaf_nodes = np.nonzero(lp[:, 0] >= 0)[0]
    start[leaf_nodes, 0] = (np.arange(len(leaf_nodes), dtype=np.int32)
                            * leaf_k)
    flat = np.full((len(leaf_nodes), leaf_k), -1, np.int64)
    flat[:, :lp.shape[1]] = lp[leaf_nodes]
    flat = flat.reshape(-1)
    rows_pad = np.concatenate(
        [rows, np.zeros((1, rows.shape[1]), rows.dtype)], axis=0)
    table = rows_pad[np.where(flat >= 0, flat, rows.shape[0])]
    nodes = np.concatenate([np.asarray(bvh.node_min, np.float32),
                            np.asarray(bvh.node_max, np.float32)], axis=1)
    links = np.stack([np.asarray(bvh.hit_link, np.int32),
                      np.asarray(bvh.miss_link, np.int32)], axis=1)
    return table, nodes, links, start


def _leaf_counts(real: np.ndarray, start: np.ndarray,
                 leaf_k: int) -> np.ndarray:
    """(M,) int32: for each node with a leaf (`start` >= 0, its first row
    of a leaf-contiguous table) the count of its rows up to its last real
    one (`real`, one flag a row), 0 for the others."""
    start = np.asarray(start).reshape(-1).astype(np.int64)
    count = np.zeros(len(start), np.int32)
    leaf = start >= 0
    if leaf.any():
        rows = np.asarray(real).reshape(-1, leaf_k)[start[leaf] // leaf_k]
        tail = np.argmax(rows[:, ::-1], axis=1)
        count[leaf] = np.where(rows.any(1), leaf_k - tail, 0)
    return count


def node_records(bounds: np.ndarray, start: np.ndarray,
                 count: np.ndarray) -> np.ndarray:
    """(M, NODE_REC_COLS) float32: a BVH's 32-byte node records as the
    kernels read them, two float4s a node: lo xyz and the leaf's first row
    as int32 bits (-1 on an internal node), hi xyz and the leaf's count of
    real rows as int32 bits (`csrc/megakernel.cuh` RtTables)."""
    rec = np.zeros((len(bounds), NODE_REC_COLS), np.float32)
    rec[:, 0:3] = bounds[:, 0:3]
    rec[:, 4:7] = bounds[:, 3:6]
    ints = rec.view(np.int32)
    ints[:, 3] = np.asarray(start).reshape(-1)
    ints[:, 7] = count
    return rec


def device_tables(bake: SceneBake) -> dict:
    """The BVH tables the kernels read, from the bake, as numpy arrays
    whose rows are whole 16-byte words: the sphere BVH's node records
    (`node_records`) with its preorder (hit, miss) links (M, 2) int32 for
    the megakernel and its octant link pairs (M, 16) int32 for the hit
    kernel (octant o's pair at columns 2o, 2o + 1); the megakernel's
    triangle BVH likewise; the hit tier's slots (Sl, TRI_SLOT_COLS) (v0 e1
    e2 and three zeros), node records and octant link pairs."""
    slots = np.zeros((len(bake.tri_geom), TRI_SLOT_COLS), np.float32)
    slots[:, :9] = bake.tri_geom
    return dict(
        sph_nodes=node_records(bake.sph_nodes, bake.sph_start,
                               bake.sph_leaf_count()),
        sph_links=np.ascontiguousarray(bake.sph_links, np.int32),
        sph_octant_links=bake.sph_hit_nodes[:, 7:].astype(np.int32),
        tri_nodes=node_records(bake.tri_nodes, bake.tri_start,
                               bake.tri_leaf_count()),
        tri_links=np.ascontiguousarray(bake.tri_links, np.int32),
        tri_slots=slots,
        tri_slot_nodes=node_records(
            bake.tri_hit_nodes[:, :6],
            bake.tri_hit_nodes[:, 6].astype(np.int32),
            bake.tri_hit_leaf_count()),
        tri_slot_links=bake.tri_hit_nodes[:, 7:].astype(np.int32))


def _octant_links(bvh: bvh_mod.FlatBVH) -> np.ndarray:
    """Eight threadings of the BVH, one per ray-direction octant (bit 2: x
    negative, bit 1: y, bit 0: z), each visiting the child nearer along its
    children's separating axis first (`pallas_trace._octant_links`,
    :596-643).  Returns (M, 16) float32: octant o's (hit, miss) links at
    columns 2o, 2o + 1."""
    hit0 = np.asarray(bvh.hit_link)
    miss0 = np.asarray(bvh.miss_link)
    m = len(hit0)
    leaf = np.asarray(bvh.leaf_prims)[:, 0] >= 0
    # children in the preorder threading: first i + 1, second miss(i + 1)
    c1 = np.arange(1, m + 1)
    c2 = np.where(~leaf, miss0[np.clip(c1, 0, m - 1)], -1)
    cen = 0.5 * (np.asarray(bvh.node_min) + np.asarray(bvh.node_max))
    out = np.zeros((m, 16), np.float32)
    for oct_ in range(8):
        neg = np.array([oct_ & 4, oct_ & 2, oct_ & 1]) != 0
        hit = np.full(m, -1, np.int64)
        miss = np.full(m, -1, np.int64)
        stack = [(0, -1)]
        while stack:
            i, succ = stack.pop()
            miss[i] = succ
            if leaf[i]:
                hit[i] = succ
                continue
            a, b = int(c1[i]), int(c2[i])
            axis = int(np.argmax(np.abs(cen[b] - cen[a])))
            if (cen[b][axis] < cen[a][axis]) != neg[axis]:
                a, b = b, a  # b is the nearer child in this octant
            hit[i] = a
            stack.append((b, succ))
            stack.append((a, b))
        out[:, 2 * oct_] = hit.astype(np.float32)
        out[:, 2 * oct_ + 1] = miss.astype(np.float32)
    return out


def used_texture_kinds(scene: st.Scene) -> set:
    """Texture kinds bound to the materials of active primitives
    (`pallas_trace._used_tex_kinds_by_class`, all classes together)."""
    tkind = scene.textures.kind[scene.materials.tex_id]
    used = set()
    for tbl in (scene.spheres, scene.rects, scene.boxes, scene.triangles):
        used |= {int(k) for k in tkind[tbl.mat_id[tbl.active]]}
    return used


def unported_feature(scene: st.Scene) -> Optional[str]:
    """The feature of `scene` that no kernel covers, or None: more than
    MAX_MEDIA constant media (`supports_scene`, pallas_trace.py:208-224)."""
    sp = scene.spheres
    n_media = int((sp.active & sp.medium).sum()
                  + (scene.boxes.active & scene.boxes.medium).sum())
    if n_media > MAX_MEDIA:
        return f"{n_media} constant media (more than {MAX_MEDIA})"
    return None


def unported_record_feature(scene: st.Scene) -> Optional[str]:
    """The feature of `scene` that the record walk does not cover, or
    None: what `unported_feature` names (the walk writes the uv planes of
    image textures)."""
    return unported_feature(scene)


def supports_forward(scene: st.Scene) -> bool:
    """True when the forward kernel renders `scene`
    (`pallas_trace.supports_forward`, :229-234): every feature but image
    textures, whose atlas the shading reads; an image scene takes the
    record walk and the torch shade."""
    return (unported_feature(scene) is None
            and st.TEX_IMAGE not in used_texture_kinds(scene))


# --------------------------------------------------------------------------
# seeds and the counter-based RNG
# --------------------------------------------------------------------------


def chunk_seed(generator: torch.Generator) -> int:
    """One draw per chunk: an int32 base in [0, 2**31 - 1) for `wave_seed`,
    as `pallas_trace.chunk_seed` draws it from a JAX key."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             dtype=torch.int64))


def wave_seed(base: int, *idx: int) -> int:
    """Per-wave kernel seed `base + s*7919 + bid*104729 (+ ...)`, wrapped to
    int32 as the JAX package's int32 arithmetic wraps (`wave_seed`,
    pallas_trace.py:2271)."""
    if len(idx) > len(_WAVE_MULTIPLIERS):
        raise ValueError(f"at most {len(_WAVE_MULTIPLIERS)} indices")
    s = int(base)
    for m, i in zip(_WAVE_MULTIPLIERS, idx):
        s += int(i) * m
    return _int32(s)


def _int32(x: int) -> int:
    """`x` wrapped to int32 two's complement."""
    return (int(x) + 2**31) % 2**32 - 2**31


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG output permutation over uint32 values held in int64
    (`pallas_trace._pcg_hash`).  Products stay below 2**62, so nothing
    overflows before the mask."""
    x = (x * 747796405 + 2891336453) & _M32
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & _M32
    return (x >> 22) ^ x


def uniform(base: torch.Tensor, salt: int) -> torch.Tensor:
    """U[0, 1) float32 for draw site `salt` (`pallas_trace._uniform`): the
    top 24 bits of the hash times 2**-24."""
    bits = pcg_hash((base + ((salt * _SALT_MUL) & _M32)) & _M32)
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def rng_base(n: int, seed: int, device) -> torch.Tensor:
    """Per-lane counter base `pcg(lane ^ (uint32(seed) * 0x85EBCA6B))` for
    lanes 0..n-1 of one call (pallas_trace.py:902-907)."""
    lane = torch.arange(n, dtype=torch.int64, device=device)
    return pcg_hash(lane ^ (((int(seed) & _M32) * _SEED_MIX) & _M32))


def pcg_uniform(seed: int, lanes: int, salt: int,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """`uniform(rng_base(lanes, seed), salt)`: float32 (lanes,).  On a CUDA
    device the `rt_pcg_uniform` kernel computes it, so the device RNG can be
    held bit for bit against the plain version."""
    device = torch.device(device)
    if device.type == "cpu":
        return uniform(rng_base(lanes, seed, device), salt)
    _require_cuda(device)
    out = torch.empty(lanes, dtype=torch.float32, device=device)
    lib = build.load()
    with torch.cuda.device(device):
        rc = lib.rt_pcg_uniform(_int32(seed), int(lanes), int(salt),
                                out.data_ptr(), _stream(device))
    _check(lib, rc, "rt_pcg_uniform")
    return out


# --------------------------------------------------------------------------
# camera constants
# --------------------------------------------------------------------------


def _cam_tuple(camera, img_h: int, img_w: int) -> tuple:
    """Camera constants for the in-kernel ray generator, as
    `pallas_trace._cam_tuple`: (origin, lower_left_corner, horizontal,
    vertical, u, v, lens_radius, time0, time1, img_h, img_w)."""
    def f3(a):
        v = a.detach().to("cpu", torch.float64).reshape(3).tolist()
        return (v[0], v[1], v[2])

    def f1(a):
        return float(a.detach().to("cpu", torch.float64))

    return (f3(camera.origin), f3(camera.lower_left_corner),
            f3(camera.horizontal), f3(camera.vertical),
            f3(camera.u), f3(camera.v),
            f1(camera.lens_radius), f1(camera.time0), f1(camera.time1),
            int(img_h), int(img_w))


def _inv_extent(dim: int) -> float:
    """float32(1 / (dim - 1)): the viewport step, with the `(dim - 1)`
    divisor of pallas_trace.py:1586-1587."""
    return _f32(1.0 / max(dim - 1, 1))


# --------------------------------------------------------------------------
# the plain PyTorch version
# --------------------------------------------------------------------------


def _guard(v: torch.Tensor) -> torch.Tensor:
    """Sign-preserving divisor guard: |v| < 1e-12 becomes +-1e-12."""
    return torch.where(v.abs() < _EPS,
                       torch.where(v >= 0, _EPS, -_EPS), v)


def _camera_rays(camera, img_h: int, img_w: int, pix_base: int, n: int,
                 base: torch.Tensor, dev: torch.device):
    """In-kernel thin-lens camera (pallas_trace.py:1569-1611): origins and
    directions, each a tuple of three (n,) float32 tensors, and the (n,)
    shutter times."""
    f32 = torch.float32
    (corg, cllc, chor, cver, cuv, cvv, clr, ct0, ct1,
     img_h, img_w) = _cam_tuple(camera, img_h, img_w)
    pix = torch.clamp(pix_base + torch.arange(n, dtype=torch.int64,
                                              device=dev),
                      max=img_h * img_w - 1)
    row = torch.div(pix, img_w, rounding_mode="floor")
    col = pix - row * img_w
    row = torch.clamp(row, max=img_h - 1)
    cdraw = (base + _CAM_DRAW) & _M32
    su = (col.to(f32) + uniform(cdraw, 0)) * _inv_extent(img_w)
    sv = ((img_h - 1 - row).to(f32) + uniform(cdraw, 1)) * _inv_extent(img_h)
    if clr != 0.0:
        theta = _TWO_PI * uniform(cdraw, 2)
        rr = clr * torch.sqrt(uniform(cdraw, 3))
        rdx = rr * torch.cos(theta)
        rdy = rr * torch.sin(theta)
        offx = cuv[0] * rdx + cvv[0] * rdy
        offy = cuv[1] * rdx + cvv[1] * rdy
        offz = cuv[2] * rdx + cvv[2] * rdy
    else:
        offx = offy = offz = torch.zeros(n, dtype=f32, device=dev)
    ox = corg[0] + offx
    oy = corg[1] + offy
    oz = corg[2] + offz
    dx = cllc[0] + su * chor[0] + sv * cver[0] - ox
    dy = cllc[1] + su * chor[1] + sv * cver[1] - oy
    dz = cllc[2] + su * chor[2] + sv * cver[2] - oz
    if ct1 != ct0:
        tm = _f32(ct0) + _f32(ct1 - ct0) * uniform(cdraw, 4)
    else:
        tm = torch.full((n,), _f32(ct0), dtype=f32, device=dev)
    return (ox, oy, oz), (dx, dy, dz), tm


class _Hit(NamedTuple):
    t: torch.Tensor       # (n,) BIG where nothing was hit
    normal: tuple         # outward normal, three (n,) tensors
    idx: torch.Tensor     # (n,) int64 row of SceneBake.shading_table()
    # with uv: the carried (u, v, is_sphere); a sphere winner's u holds its
    # rotate_y phase until `_resolve_uv`
    uv: Optional[tuple] = None


def _closest_hit(bake: SceneBake, o3: tuple, d3: tuple, tm: torch.Tensor,
                 t_min: float, n: int, dev: torch.device,
                 alive: torch.Tensor, walk: Optional[dict] = None,
                 uv: bool = False) -> _Hit:
    """Closest hit over the baked rects, then boxes, then spheres, then
    triangles, strict `<` (pallas_trace.py:961-1043, 1105-1289): the
    spheres a dense loop over the rows, or under a BVH the kernel's walk.
    With `walk` (a dict of counts), the node and row tests that the
    kernel's sphere-BVH walk makes on the `alive` lanes, and its triangle
    walk's node and candidate tests, are added to it.  Only the `alive`
    lanes walk the BVHs.

    With `uv`, the uv carry of the record kernel's `need_uv` mode
    (pallas_trace.py:930-958): a rect winner's uv from its hit coordinates
    (:970-974), a triangle's interpolated uv (:1235-1239), a sphere's
    rotate_y phase in u with the sphere flag (:1164-1169); a box winner
    passes no uv, so it keeps the carried uv of the closest rect hit, or 0
    (a reference quirk the port keeps)."""
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    t_best = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    nx, ny, nz = zeros, zeros, zeros
    idx = torch.zeros(n, dtype=torch.int64, device=dev)
    uu, vv = zeros, zeros
    sphf = torch.zeros(n, dtype=torch.bool, device=dev)

    def upd(ok, t, nxx, nyy, nzz, row):
        """Keep (t, normal, row) where strictly closer; the lanes that
        took it."""
        nonlocal t_best, nx, ny, nz, idx
        better = ok & (t < t_best)
        t_best = torch.where(better, t, t_best)
        nx = torch.where(better, nxx, nx)
        ny = torch.where(better, nyy, ny)
        nz = torch.where(better, nzz, nz)
        idx = torch.where(better, row, idx)
        return better

    def upd_uv(better, u_, v_, is_sph: bool):
        nonlocal uu, vv, sphf
        uu = torch.where(better, u_, uu)
        vv = torch.where(better, v_, vv)
        sphf = (sphf | better) if is_sph else (sphf & ~better)

    ox, oy, oz = o3
    dx, dy, dz = d3
    row = 1
    for prim in bake.rects:
        ax = prim["axis"]
        t = (prim["k"] - o3[ax]) / _guard(d3[ax])
        a_ax = 1 if ax == 0 else 0
        b_ax = 1 if ax == 2 else 2
        pa = o3[a_ax] + t * d3[a_ax]
        pb = o3[b_ax] + t * d3[b_ax]
        ok = ((t >= t_min) & (pa >= prim["a0"]) & (pa <= prim["a1"])
              & (pb >= prim["b0"]) & (pb <= prim["b1"]))
        n3 = [zeros, zeros, zeros]
        n3[ax] = torch.ones_like(zeros)
        better = upd(ok, t, *n3, row)
        if uv:
            upd_uv(better,
                   _div(pa - prim["a0"], _extent(prim["a1"], prim["a0"])),
                   _div(pb - prim["b0"], _extent(prim["b1"], prim["b0"])),
                   False)
        row += 1

    for prim in bake.boxes:
        (ox2, oy_t, oz2), (dx2, dz2) = _box_interval(prim, o3, d3)
        tnx, tfx, tny, tfy, tnz, tfz = _slabs(prim, ox2, oy_t, oz2, dx2, dy,
                                              dz2)
        tn = torch.maximum(torch.maximum(tnx, tny), tnz)
        tf = torch.minimum(torch.minimum(tfx, tfy), tfz)
        hit_iv = tf > torch.clamp(tn, min=0.0)
        t = torch.where(tn >= t_min, tn, tf)
        ok = hit_iv & (t >= t_min)
        # face: the slab whose bound equals the hit t, flipped on exit
        is_x = (t == tnx) | (t == tfx)
        is_y = (t == tny) | (t == tfy)
        exiting = t == tf
        sx = torch.where((dx2 >= 0) ^ exiting, -1.0, 1.0)
        sy = torch.where((dy >= 0) ^ exiting, -1.0, 1.0)
        sz = torch.where((dz2 >= 0) ^ exiting, -1.0, 1.0)
        nobj_x = torch.where(is_x, sx, 0.0)
        nobj_y = torch.where(~is_x & is_y, sy, 0.0)
        nobj_z = torch.where(~is_x & ~is_y, sz, 0.0)
        # object -> world rotation of the normal
        c, s = prim["cos"], prim["sin"]
        nwx = c * nobj_x + s * nobj_z
        nwz = (-s) * nobj_x + c * nobj_z
        upd(ok, t, nwx, nobj_y, nwz, row)  # no uv: the carried one stays
        row += 1

    sph = None
    if len(bake.sph_nodes):
        # the kernels' walk: a ray that grazes a node's box can round out
        # of it and miss a sphere that a dense loop over the rows finds
        # (one lane of the 5.77M of a big_scene1 training chunk)
        w = sphere_walk_reference(bake, o3, d3, tm, t_min, t_best, alive)
        sph = _sphere_hit(_SphereRows.of(bake.sphere_table, dev), o3, d3,
                          tm, w.better, w.t, w.row)
        if walk is not None:
            walk["nodes"] += int(w.nodes.sum())
            walk["rows"] += int(w.rows.sum())
            walk["leaf_tests"] = walk["leaf_tests"] + w.leaf_tests
    elif len(bake.sphere_table):
        sph = _closest_sphere(bake.sphere_table, o3, d3, tm, t_min, t_best)
    if sph is not None:
        better = upd(sph.better, sph.t, *sph.normal, row + sph.row)
        if uv:
            phase = torch.as_tensor(bake.sphere_table[:, SPHERE_SH + SH_COLS],
                                    device=dev)[sph.row]
            upd_uv(better, phase, zeros, True)
    if len(bake.tri_nodes):
        tw = tri_walk_reference(bake, o3, d3, t_min, t_best, alive)
        first = (row + len(bake.sphere_table) + len(bake.sphere_media)
                 + len(bake.box_media))
        better = upd(tw.better, tw.t, *tri_normal(bake.tri_table, tw, dev),
                     first + tw.row)
        if uv:
            upd_uv(better, *tri_uv(bake.tri_table, tw, dev), False)
        if walk is not None:
            walk["tri_nodes"] += int(tw.nodes.sum())
            walk["tri_rows"] += int(tw.rows.sum())
            walk["tri_wins"] += int(tw.better.sum())
            walk["tri_leaf_tests"] = walk["tri_leaf_tests"] + tw.leaf_tests
            walk["tri_read"] = tri_reads(tw, len(bake.tri_table))
    return _Hit(t_best, (nx, ny, nz), idx, (uu, vv, sphf) if uv else None)


class _SphereHit(NamedTuple):
    better: torch.Tensor  # (n,) bool, a sphere row beats the given t_best
    t: torch.Tensor       # (n,) its distance
    normal: tuple         # its outward normal (n - c) / r, three (n,)
    row: torch.Tensor     # (n,) int64 its row in the table


_SPHERE_CHUNK = 128  # sphere rows per step of the plain versions' dense test


class _SphereRows(NamedTuple):
    """The (S, 24) sphere table on a device, with the per-row terms of the
    kernels' sphere test (`sphere_candidate`, pallas_trace.py:1105-1168;
    `sph_cand`, :1877-1925): shutter-span divisor, center motion,
    radius and its square."""

    q: torch.Tensor
    denom: torch.Tensor
    dc: torch.Tensor
    rad: torch.Tensor
    rr: torch.Tensor

    @classmethod
    def of(cls, table: np.ndarray, dev: torch.device) -> "_SphereRows":
        q = torch.as_tensor(table, device=dev)
        span = q[:, 7] - q[:, 6]
        rad = q[:, 8]
        return cls(q, torch.where(span.abs() < _EPS, 1.0, span),
                   q[:, 3:6] - q[:, 0:3], rad, rad * rad)

    def center(self, frac: torch.Tensor, rows) -> tuple:
        return tuple(self.q[rows, k] + frac * self.dc[rows, k]
                     for k in range(3))

    def distance(self, rows, o3: tuple, d3: tuple, tm: torch.Tensor,
                 a: torch.Tensor, inv_a: torch.Tensor,
                 t_min: float) -> torch.Tensor:
        """The nearest root past t_min of rows `rows` (a slice or an index
        tensor) against rays that broadcast against them, BIG where none:
        the center moves to the ray's time, and an all-zero pad row of the
        leaf-contiguous table never hits (radius 0)."""
        frac = (tm - self.q[rows, 6]) / self.denom[rows]
        cx, cy, cz = self.center(frac, rows)
        ocx, ocy, ocz = o3[0] - cx, o3[1] - cy, o3[2] - cz
        hb = ocx * d3[0] + ocy * d3[1] + ocz * d3[2]
        cc = ocx * ocx + ocy * ocy + ocz * ocz - self.rr[rows]
        disc = hb * hb - a * cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        near = (-hb - sq) * inv_a
        far = (-hb + sq) * inv_a
        has = (disc > 0.0) & (self.rad[rows].abs() > 0.0)
        return torch.where(has & (near >= t_min), near,
                           torch.where(has & (far >= t_min), far, BIG))


def _closest_sphere(table: np.ndarray, o3: tuple, d3: tuple,
                    tm: torch.Tensor, t_min: float,
                    t_best: torch.Tensor) -> _SphereHit:
    """The first sphere row with the least distance below `t_best`: every
    row of the (S, 24) table against every lane, a chunk of rows at a
    time, with the kernels' arithmetic per (lane, row).  The first
    occurrence of the least distance is what a loop over the rows with a
    strict `<` keeps.  A negative radius turns the normal inward."""
    dev = tm.device
    sr = _SphereRows.of(table, dev)
    dx, dy, dz = d3
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / torch.clamp(a, min=_EPS)
    best_t = torch.full_like(tm, BIG)
    best_row = torch.zeros(tm.shape, dtype=torch.int64, device=dev)
    col = (lambda x: x[:, None])
    for lo in range(0, len(sr.q), _SPHERE_CHUNK):
        t = sr.distance(slice(lo, lo + _SPHERE_CHUNK), tuple(map(col, o3)),
                        tuple(map(col, d3)), col(tm), col(a), col(inv_a),
                        t_min)
        j = torch.argmin(t, dim=1)  # the first of equal minima
        t_j = torch.gather(t, 1, j[:, None])[:, 0]
        take = t_j < best_t
        best_t = torch.where(take, t_j, best_t)
        best_row = torch.where(take, lo + j, best_row)
    return _sphere_hit(sr, o3, d3, tm,
                       (best_t < BIG * 0.5) & (best_t < t_best), best_t,
                       best_row)


def _sphere_hit(sr: _SphereRows, o3: tuple, d3: tuple, tm: torch.Tensor,
                better: torch.Tensor, best_t: torch.Tensor,
                best_row: torch.Tensor) -> _SphereHit:
    """The winning row's hit: its normal at distance `best_t` (the center
    at the ray's time; a negative radius turns it inward)."""
    frac = (tm - sr.q[best_row, 6]) / sr.denom[best_row]
    cx, cy, cz = sr.center(frac, best_row)
    rad = sr.rad[best_row]
    inv_r = 1.0 / torch.where(rad.abs() < _EPS, 1.0, rad)
    normal = tuple((o + best_t * d - c) * inv_r
                   for o, d, c in zip(o3, d3, (cx, cy, cz)))
    return _SphereHit(better, best_t, normal, best_row)


class SphereWalk(NamedTuple):
    """What the kernels' sphere-BVH walk finds and does, lane by lane."""

    better: torch.Tensor  # (n,) bool, a sphere row beats the given t_best
    t: torch.Tensor       # (n,) the walk's closest distance
    row: torch.Tensor     # (n,) int64 its row in the leaf-contiguous table
    nodes: torch.Tensor   # (n,) int64 node slab tests
    rows: torch.Tensor    # (n,) int64 sphere rows tested
    leaf_tests: torch.Tensor  # (M,) int64 lanes that tested each node's leaf


def sphere_walk_reference(bake: SceneBake, o3: tuple, d3: tuple,
                          tm: torch.Tensor, t_min: float,
                          t_best: torch.Tensor, alive: torch.Tensor,
                          octant: bool = False) -> SphereWalk:
    """The stackless sphere-BVH walk of the kernels, every live lane in
    lockstep: slab-test the lane's node against its closest hit so far
    (`tn <= t`), test a hit leaf's real rows (`sph_leaf_count`) in order
    with a strict `<`, then follow the node's hit or miss link until -1.
    `megakernel_fwd` follows the preorder links (`sph_links`, octant
    False); `rt_hit` the links of the ray's own direction octant
    (`sph_hit_nodes`, octant True).

    The plain versions under a sphere BVH take this walk's winner (the
    megakernel's `_closest_hit` the preorder walk, `hit_reference` the
    octant walk), so a ray that rounds out of a node's box misses there as
    in the kernels; it also counts the node and row tests a walk makes,
    which bound the kernels' work."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    dev = tm.device
    nodes = torch.as_tensor(bake.sph_nodes, device=dev)
    start = torch.as_tensor(bake.sph_start[:, 0], device=dev).long()
    count = torch.as_tensor(bake.sph_leaf_count(), device=dev).long()
    if octant:
        links = torch.as_tensor(bake.sph_hit_nodes[:, 7:], device=dev).long()
        oct_ = ((dx < 0).long() << 2) | ((dy < 0).long() << 1) | (dz < 0).long()
        col = 2 * oct_
    else:
        links = torch.as_tensor(bake.sph_links, device=dev).long()
        col = torch.zeros_like(tm, dtype=torch.int64)
    sr = _SphereRows.of(bake.sphere_table, dev)
    ivx, ivy, ivz = 1.0 / _guard(dx), 1.0 / _guard(dy), 1.0 / _guard(dz)
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / torch.clamp(a, min=_EPS)
    best_t = t_best.clone()
    best_row = torch.zeros_like(col)
    n_nodes, n_rows = torch.zeros_like(col), torch.zeros_like(col)
    leaf_tests = torch.zeros(len(nodes), dtype=torch.int64, device=dev)
    node = torch.where(alive, 0, -1).long()
    while bool((node >= 0).any()):
        active = node >= 0
        at = node.clamp(min=0)
        nd = nodes[at]
        tx0, tx1 = (nd[:, 0] - ox) * ivx, (nd[:, 3] - ox) * ivx
        ty0, ty1 = (nd[:, 1] - oy) * ivy, (nd[:, 4] - oy) * ivy
        tz0, tz1 = (nd[:, 2] - oz) * ivz, (nd[:, 5] - oz) * ivz
        tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                         torch.minimum(ty0, ty1)),
                           torch.minimum(tz0, tz1))
        tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                         torch.maximum(ty0, ty1)),
                           torch.maximum(tz0, tz1))
        hit_box = (active & (tf >= torch.clamp(tn, min=t_min))
                   & (tn <= best_t))
        leaf = hit_box & (start[at] >= 0)
        for k in range(SPH_LEAF_K):
            r = torch.where(leaf, start[at] + k, 0)
            t = sr.distance(r, o3, d3, tm, a, inv_a, t_min)
            take = (leaf & (k < count[at]) & (t < BIG * 0.5)
                    & (t < best_t))
            best_t = torch.where(take, t, best_t)
            best_row = torch.where(take, r, best_row)
        n_nodes += active.long()
        n_rows += count[at] * leaf.long()
        leaf_tests += torch.bincount(at[leaf], minlength=len(nodes))
        nxt = links[at, col + (~hit_box).long()]
        node = torch.where(active, nxt, -1)
    better = alive & (best_t < t_best)
    return SphereWalk(better, best_t, best_row, n_nodes, n_rows, leaf_tests)


class TriWalk(NamedTuple):
    """What the kernels' triangle-BVH walk finds and does, lane by lane."""

    better: torch.Tensor  # (n,) bool, a triangle beats the given t_best
    t: torch.Tensor       # (n,) the walk's closest distance
    row: torch.Tensor     # (n,) int64 the winner's row (megakernel) or slot
    ub: torch.Tensor      # (n,) its barycentric weights of vertices 1, 2
    vb: torch.Tensor
    nodes: torch.Tensor   # (n,) int64 node slab tests
    rows: torch.Tensor    # (n,) int64 triangle candidates tested
    node_seen: torch.Tensor   # (M,) bool, the nodes any lane tested
    link_seen: torch.Tensor   # (M, links) bool, the link columns followed
    leaf_seen: torch.Tensor   # (leaves,) bool, the leaves any lane tested
    leaf_tests: torch.Tensor  # (M,) int64 lanes that tested each node's leaf


def tri_candidates(g: torch.Tensor, o3: tuple, d3: tuple, t_min: float):
    """Moller-Trumbore (reference triangle.h:120-178, pallas_trace.py:
    1193-1250, :2066-2099) of rays against candidates: g (..., 9) the
    candidates' v0 e1 e2, o3/d3 broadcasting against g[..., 0].  Returns
    (t, ub, vb, ok); an all-zero pad candidate fails the |det| > 1e-7 test,
    and so do degenerate triangles."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = g.unbind(-1)
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / torch.where(a.abs() < TRI_DET, TRI_DET, a)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    ub = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vb = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = ((a.abs() > TRI_DET) & (ub >= 0.0) & (ub <= 1.0) & (vb >= 0.0)
          & (ub + vb <= 1.0) & (t >= t_min))
    return t, ub, vb, ok


def tri_walk_reference(bake: SceneBake, o3: tuple, d3: tuple, t_min: float,
                       t_best: torch.Tensor, alive: torch.Tensor,
                       octant: bool = False) -> TriWalk:
    """The stackless triangle-BVH walk of the kernels, every live lane in
    lockstep: slab-test the lane's node against its closest hit so far
    (`tn <= t`), test a hit leaf's candidates in order and keep one only
    when strictly closer, then follow the node's hit or miss link until -1.
    A lane's closest hit starts at `t_best` (what it hit before the
    triangles), so `better` marks the lanes a triangle wins.

    octant False: `megakernel_fwd`'s walk, preorder links over the rows of
    `tri_table` in leaves of TRI_LEAF_K (`row` is a table row).  octant
    True: `rt_hit`'s triangle tier, the links of the ray's own direction
    octant over `tri_geom` in leaves of HIT_TRI_LEAF_K (`row` is a slot).
    A leaf's real rows are tested, not the pads at its tail.  Among equal
    distances the first in the lane's visit order wins, so a ray through
    an edge that two triangles share keeps the one the kernel keeps.  The
    node and candidate tests are counted for the bounds."""
    dx, dy, dz = d3
    dev = t_best.device
    if octant:
        hn = torch.as_tensor(bake.tri_hit_nodes, device=dev)
        bounds, start = hn[:, :6], hn[:, 6].long()
        links = hn[:, 7:].long()
        oct_ = ((dx < 0).long() << 2) | ((dy < 0).long() << 1) | (dz < 0).long()
        col = 2 * oct_
        geom = torch.as_tensor(bake.tri_geom, device=dev)
        count = bake.tri_hit_leaf_count()
        leaf_k = HIT_TRI_LEAF_K
    else:
        bounds = torch.as_tensor(bake.tri_nodes, device=dev)
        start = torch.as_tensor(bake.tri_start[:, 0], device=dev).long()
        links = torch.as_tensor(bake.tri_links, device=dev).long()
        col = torch.zeros_like(t_best, dtype=torch.int64)
        geom = torch.as_tensor(bake.tri_table[:, :9], device=dev)
        count = bake.tri_leaf_count()
        leaf_k = TRI_LEAF_K
    count = torch.as_tensor(count, device=dev).long()
    ivx, ivy, ivz = 1.0 / _guard(dx), 1.0 / _guard(dy), 1.0 / _guard(dz)
    best_t = t_best.clone()
    zero_f = torch.zeros_like(best_t)
    best_row = torch.full_like(col, -1)
    best_u, best_v = zero_f.clone(), zero_f.clone()
    n_nodes, n_rows = torch.zeros_like(col), torch.zeros_like(col)
    node_seen = torch.zeros(len(bounds), dtype=torch.bool, device=dev)
    link_seen = torch.zeros(links.shape, dtype=torch.bool, device=dev)
    leaf_seen = torch.zeros(len(geom) // leaf_k, dtype=torch.bool,
                            device=dev)
    leaf_tests = torch.zeros(len(bounds), dtype=torch.int64, device=dev)
    ks = torch.arange(leaf_k, device=dev)
    node = torch.where(alive, 0, -1).long()
    while bool((node >= 0).any()):
        active = node >= 0
        at = node.clamp(min=0)
        nd = bounds[at]
        ox, oy, oz = o3
        tx0, tx1 = (nd[:, 0] - ox) * ivx, (nd[:, 3] - ox) * ivx
        ty0, ty1 = (nd[:, 1] - oy) * ivy, (nd[:, 4] - oy) * ivy
        tz0, tz1 = (nd[:, 2] - oz) * ivz, (nd[:, 5] - oz) * ivz
        tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                         torch.minimum(ty0, ty1)),
                           torch.minimum(tz0, tz1))
        tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                         torch.maximum(ty0, ty1)),
                           torch.maximum(tz0, tz1))
        hit_box = (active & (tf >= torch.clamp(tn, min=t_min))
                   & (tn <= best_t))
        leaf = hit_box & (start[at] >= 0)
        lanes = torch.nonzero(leaf)[:, 0]
        if len(lanes):
            # the leaf's candidates side by side: the first of the least
            # distances is what a strict `<` over them in order keeps
            rows = start[at[lanes]][:, None] + ks
            col1 = (lambda x: x[lanes][:, None])
            t, ub, vb, ok = tri_candidates(
                geom[rows], tuple(map(col1, o3)), tuple(map(col1, d3)), t_min)
            t = torch.where(ok & (ks < count[at[lanes]][:, None]), t, BIG)
            j = torch.argmin(t, dim=1)
            pick = (lambda x: torch.gather(x, 1, j[:, None])[:, 0])
            t_j = pick(t)
            take = t_j < best_t[lanes]
            won = lanes[take]
            best_t[won] = t_j[take]
            best_row[won] = pick(rows)[take]
            best_u[won] = pick(ub)[take]
            best_v[won] = pick(vb)[take]
            leaf_seen[start[at[lanes]] // leaf_k] = True
        n_nodes += active.long()
        n_rows += count[at] * leaf.long()
        leaf_tests += torch.bincount(at[leaf], minlength=len(bounds))
        link = col + (~hit_box).long()
        node_seen[at[active]] = True
        link_seen[at[active], link[active]] = True
        nxt = links[at, link]
        node = torch.where(active, nxt, -1)
    better = alive & (best_t < t_best)
    return TriWalk(better, best_t, best_row, best_u, best_v, n_nodes, n_rows,
                   node_seen, link_seen, leaf_seen, leaf_tests)


def tri_reads(walk: TriWalk, n_rows: int) -> dict:
    """The parts of a triangle BVH's tables that a walk reads, as masks:
    the nodes it tests, the link columns it follows, the leaves it tests
    and the rows (megakernel) or slots (hit tier) that win."""
    won = torch.zeros(n_rows, dtype=torch.bool, device=walk.row.device)
    won[walk.row[walk.better]] = True
    return dict(nodes=walk.node_seen, links=walk.link_seen,
                leaves=walk.leaf_seen, won=won)


def merge_reads(a: Optional[dict], b: Optional[dict]) -> Optional[dict]:
    """The union of two `tri_reads`; `a` is None before the first walk,
    and both are None in a scene without triangles."""
    return b if a is None else {k: a[k] | b[k] for k in a}


def tri_normal(table: np.ndarray, tw: TriWalk, dev: torch.device) -> tuple:
    """A triangle winner's outward normal, its vertex normals (or its face
    normal thrice) weighted by (1 - ub - vb, ub, vb), with the kernels'
    order of operations (pallas_trace.py:1227-1234)."""
    return _tri_lerp(table, tw, dev, TRI_N0, 3)


def tri_uv(table: np.ndarray, tw: TriWalk, dev: torch.device) -> tuple:
    """A triangle winner's uv, its vertices' uv weighted as `tri_normal`
    weights the normals (pallas_trace.py:1235-1239)."""
    return _tri_lerp(table, tw, dev, TRI_UV0, 2)


def _tri_lerp(table: np.ndarray, tw: TriWalk, dev: torch.device, col: int,
              width: int) -> tuple:
    q = torch.as_tensor(table, device=dev)[tw.row.clamp(min=0)]
    wb = 1.0 - tw.ub - tw.vb
    return tuple(wb * q[:, col + k] + tw.ub * q[:, col + width + k]
                 + tw.vb * q[:, col + 2 * width + k] for k in range(width))


def _box_interval(prim, o3: tuple, d3: tuple):
    """A box's world -> object transform (box.h + hittable.h wrappers):
    (object-space origin, rotated direction x and z)."""
    ox, oy, oz = o3
    dx, _, dz = d3
    c, s = prim["cos"], prim["sin"]
    offx_b, offy_b, offz_b = prim["off"]
    ox_t = ox - offx_b
    oy_t = oy - offy_b
    oz_t = oz - offz_b
    ox2 = c * ox_t - s * oz_t
    oz2 = s * ox_t + c * oz_t
    dx2 = c * dx - s * dz
    dz2 = s * dx + c * dz
    return (ox2, oy_t, oz2), (dx2, dz2)


def _slabs(prim, ox2, oy_t, oz2, dx2, dy, dz2):
    """The near and far slab distances (tnx, tfx, tny, tfy, tnz, tfz)."""
    lo, hi = prim["bmin"], prim["bmax"]
    ivx, ivy, ivz = 1.0 / _guard(dx2), 1.0 / _guard(dy), 1.0 / _guard(dz2)
    tx0 = (lo[0] - ox2) * ivx
    tx1 = (hi[0] - ox2) * ivx
    ty0 = (lo[1] - oy_t) * ivy
    ty1 = (hi[1] - oy_t) * ivy
    tz0 = (lo[2] - oz2) * ivz
    tz1 = (hi[2] - oz2) * ivz
    return (torch.minimum(tx0, tx1), torch.maximum(tx0, tx1),
            torch.minimum(ty0, ty1), torch.maximum(ty0, ty1),
            torch.minimum(tz0, tz1), torch.maximum(tz0, tz1))


def _media_hit(bake: SceneBake, h: _Hit, o3: tuple, d3: tuple,
               tm: torch.Tensor, t_min: float, draw: torch.Tensor) -> _Hit:
    """Constant media (reference constant_medium.h:34-70,
    pallas_trace.py:1297-1395): per boundary, its [enter, exit] interval
    clipped by the closest solid hit and an exponential free path drawn
    with salt 16 + index; the nearest scatter event wins over the surface,
    with the arbitrary normal (1, 0, 0)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    media = bake.media_table()
    n_sph = len(bake.sphere_media)
    first_row = 1 + len(bake.rects) + len(bake.boxes) + len(bake.sphere_table)
    d_len = torch.sqrt(dx * dx + dy * dy + dz * dz)
    inv_dlen = 1.0 / torch.clamp(d_len, min=_LEN_FLOOR)
    m_t = torch.full_like(h.t, BIG)
    m_idx = torch.zeros_like(h.idx)
    for im, rec in enumerate(media):
        if im < n_sph:
            c0x, c0y, c0z, dcx, dcy, dcz, t0, inv_span, r2 = (
                float(v) for v in rec[1:10])
            frac = (tm - t0) * inv_span
            ocx = ox - (c0x + frac * dcx)
            ocy = oy - (c0y + frac * dcy)
            ocz = oz - (c0z + frac * dcz)
            a = dx * dx + dy * dy + dz * dz
            hb = ocx * dx + ocy * dy + ocz * dz
            cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
            disc = hb * hb - a * cc
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            inv_a = 1.0 / torch.clamp(a, min=_EPS)
            lo = (-hb - sq) * inv_a
            hi = (-hb + sq) * inv_a
            exists = disc > 0.0
        else:
            m = bake.box_media[im - n_sph]
            (ox2, oy_t, oz2), (dx2, dz2) = _box_interval(m, o3, d3)
            tnx, tfx, tny, tfy, tnz, tfz = _slabs(m, ox2, oy_t, oz2, dx2, dy,
                                                  dz2)
            lo = torch.maximum(torch.maximum(tnx, tny), tnz)
            hi = torch.minimum(torch.minimum(tfx, tfy), tfz)
            exists = hi > lo
        enter = torch.clamp(lo, min=t_min)
        exit_ = torch.minimum(hi, h.t)
        seg = (exit_ - enter) * d_len
        u_fp = torch.clamp(uniform(draw, 16 + im), min=_EPS)
        hit_dist = float(rec[0]) * torch.log(u_fp)
        t_m = enter + hit_dist * inv_dlen
        ok = exists & (exit_ > enter) & (hit_dist <= seg)
        better = ok & (t_m < m_t)
        m_t = torch.where(better, t_m, m_t)
        m_idx = torch.where(better, first_row + im, m_idx)
    win = m_t < h.t
    nx, ny, nz = h.normal
    uv = h.uv
    if uv is not None:  # a medium winner's uv is 0 (:1392-1395)
        uv = (torch.where(win, 0.0, uv[0]), torch.where(win, 0.0, uv[1]),
              uv[2] & ~win)
    return _Hit(torch.where(win, m_t, h.t),
                (torch.where(win, 1.0, nx), torch.where(win, 0.0, ny),
                 torch.where(win, 0.0, nz)),
                torch.where(win, m_idx, h.idx), uv)


def _scene_hit(bake: SceneBake, o3: tuple, d3: tuple, tm: torch.Tensor,
               t_min: float, draw: torch.Tensor, n: int,
               dev: torch.device, alive: torch.Tensor,
               walk: Optional[dict] = None, uv: bool = False) -> _Hit:
    h = _closest_hit(bake, o3, d3, tm, t_min, n, dev, alive, walk, uv)
    if bake.sphere_media or bake.box_media:
        h = _media_hit(bake, h, o3, d3, tm, t_min, draw)
    return h


def _resolve_uv(h: _Hit) -> tuple:
    """The final (u, v) of a hit carried with uv: a sphere winner's from
    its pre-flip outward normal and its phase (pallas_trace.py:1400-1410),
    every other winner's as carried."""
    u, v, sph = h.uv
    su, sv = _sphere_uv(h.normal, u)
    return torch.where(sph, su, u), torch.where(sph, sv, v)


def _draw_window(base: torch.Tensor, b: int) -> torch.Tensor:
    """Bounce b's draw base: base + uint32(b * 32) * 0x68E31DA4 (:1294)."""
    return (base + (((b * 32) * _DRAW_MUL) & _M32)) & _M32


def _unit_vector(draw: torch.Tensor, salt: int) -> tuple:
    """Uniform direction on the sphere, salts `salt` and `salt + 1`."""
    z = 2.0 * uniform(draw, salt) - 1.0
    phi = _TWO_PI * uniform(draw, salt + 1)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return r * torch.cos(phi), r * torch.sin(phi), z


def _in_sphere(draw: torch.Tensor, salt: int) -> tuple:
    """Uniform point in the unit ball, salts `salt` to `salt + 2`; the
    radius u**(1/3) as exp(log(u) / 3) (:690-695)."""
    ux, uy, uz = _unit_vector(draw, salt)
    u = torch.clamp(uniform(draw, salt + 2), min=_EPS)
    r = torch.exp(torch.log(u) * _THIRD)
    return r * ux, r * uy, r * uz


def _surface(h: _Hit, o3: tuple, d3: tuple):
    """(front, unit normal against the ray, hit point): set_face_normal +
    normalize (:1413-1423)."""
    nx, ny, nz = h.normal
    dx, dy, dz = d3
    front = (dx * nx + dy * ny + dz * nz) < 0.0
    flip = torch.where(front, 1.0, -1.0)
    nlen = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                        min=_NORM_FLOOR))
    n3 = (nx * flip * nlen, ny * flip * nlen, nz * flip * nlen)
    p3 = tuple(o + h.t * d for o, d in zip(o3, d3))
    return front, n3, p3


def _albedo(tex_kinds: set, sh: torch.Tensor, p3: tuple) -> tuple:
    """Deferred texture evaluation on the winner's shading block
    (`_deferred_albedo`, :782-818): solid c1, checker, noise, turbulence,
    marble; the families the scene does not use are left out."""
    ar, ag, ab = sh[:, SH_C1], sh[:, SH_C1 + 1], sh[:, SH_C1 + 2]
    texk, scale = sh[:, SH_TEXK], sh[:, SH_SCALE]
    px, py, pz = p3
    if st.TEX_CHECKER in tex_kinds:
        sines = (torch.sin(scale * px) * torch.sin(scale * py)
                 * torch.sin(scale * pz))
        odd = (texk == st.TEX_CHECKER) & (sines < 0.0)
        ar = torch.where(odd, sh[:, SH_C2], ar)
        ag = torch.where(odd, sh[:, SH_C2 + 1], ag)
        ab = torch.where(odd, sh[:, SH_C2 + 2], ab)
    if tex_kinds & _PERLIN_KINDS:
        spx, spy, spz = scale * px, scale * py, scale * pz
        turb_v = perlin.turb3(spx, spy, spz)
        grays = []
        if st.TEX_NOISE in tex_kinds:
            grays.append((st.TEX_NOISE,
                          0.5 * (1.0 + perlin.noise3(spx, spy, spz))))
        if st.TEX_TURB in tex_kinds:
            grays.append((st.TEX_TURB, turb_v))
        if st.TEX_MARBLE in tex_kinds:
            grays.append((st.TEX_MARBLE,
                          0.5 * (1.0 + torch.sin(scale * pz + 10.0 * turb_v))))
        for kind, gray in grays:
            sel = texk == kind
            ar = torch.where(sel, gray, ar)
            ag = torch.where(sel, gray, ag)
            ab = torch.where(sel, gray, ab)
    return ar, ag, ab


def _scatter(mat_kinds: set, draw: torch.Tensor, kind: torch.Tensor,
             sh: torch.Tensor, front: torch.Tensor, n3: tuple, d3: tuple):
    """(next direction, ok) of every lane (:1444-1513): lambertian n + unit
    vector (salts 0-1); metal reflect + fuzz * in_sphere (salts 3-5), ok
    only above the surface; dielectric Schlick reflect or refract (salt 7);
    isotropic in_sphere.  Kinds the scene does not use are left out."""
    nx, ny, nz = n3
    ux, uy, uz = _unit_vector(draw, 0)
    ldx, ldy, ldz = nx + ux, ny + uy, nz + uz
    degen = ((ldx.abs() < _DEGEN) & (ldy.abs() < _DEGEN)
             & (ldz.abs() < _DEGEN))
    out = (torch.where(degen, nx, ldx), torch.where(degen, ny, ldy),
           torch.where(degen, nz, ldz))
    ok = torch.ones_like(degen)
    if not mat_kinds & {st.METAL, st.DIELECTRIC, st.ISOTROPIC}:
        return out, ok

    def pick(sel, new):
        return tuple(torch.where(sel, a, b) for a, b in zip(new, out))

    dx, dy, dz = d3
    dlen = 1.0 / torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz,
                                        min=_NORM_FLOOR))
    udx, udy, udz = dx * dlen, dy * dlen, dz * dlen
    dn = udx * nx + udy * ny + udz * nz
    r3 = (udx - 2.0 * dn * nx, udy - 2.0 * dn * ny, udz - 2.0 * dn * nz)
    s3 = _in_sphere(draw, 3)
    if st.METAL in mat_kinds:
        fuzz = sh[:, SH_FUZZ]
        m3 = tuple(r + fuzz * v for r, v in zip(r3, s3))
        is_metal = kind == st.METAL
        out = pick(is_metal, m3)
        ok = ~is_metal | ((m3[0] * nx + m3[1] * ny + m3[2] * nz) > 0.0)
    if st.DIELECTRIC in mat_kinds:
        ir = sh[:, SH_IR]
        ratio = torch.where(front, 1.0 / ir, ir)
        cos_t = torch.clamp(-(udx * nx + udy * ny + udz * nz), max=1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        cannot = ratio * sin_t > 1.0
        r0 = (1.0 - ratio) / (1.0 + ratio)
        r0 = r0 * r0
        om = 1.0 - cos_t
        om2 = om * om
        schlick = r0 + (1.0 - r0) * om2 * om2 * om
        reflect = cannot | (schlick > uniform(draw, 7))
        per = tuple(ratio * (u + cos_t * nn)
                    for u, nn in zip((udx, udy, udz), n3))
        k2 = torch.clamp(1.0 - (per[0] * per[0] + per[1] * per[1]
                                + per[2] * per[2]), min=0.0)
        par = -torch.sqrt(k2)
        f3 = tuple(pp + par * nn for pp, nn in zip(per, n3))
        out = pick(kind == st.DIELECTRIC,
                   tuple(torch.where(reflect, r, f) for r, f in zip(r3, f3)))
    if st.ISOTROPIC in mat_kinds:
        out = pick(kind == st.ISOTROPIC, s3)
    return out, ok


class _Bounce(NamedTuple):
    hit: torch.Tensor    # (n,) bool, alive and hit something
    miss: torch.Tensor   # (n,) bool, alive and escaped
    cont: torch.Tensor   # (n,) bool, the path goes on (before RR)
    kind: torch.Tensor   # (n,) int32 material kind of the winner
    sh: torch.Tensor     # (n, 12) the winner's shading block
    p3: tuple            # hit point
    d3: tuple            # next direction (where hit)
    uv: Optional[tuple] = None  # final (u, v) of the winner, when asked


def _bounce(bake: SceneBake, shading: torch.Tensor, base: torch.Tensor,
            b: int, alive: torch.Tensor, o3: tuple, d3: tuple,
            tm: torch.Tensor, t_min: float, n: int,
            dev: torch.device, counts: Optional[dict] = None,
            uv: bool = False) -> tuple:
    """One bounce of every lane, shared by both modes: closest hit, media,
    face normal and scatter; returns (the bounce's _Bounce, its draw).
    With `counts` (see `trace_pixels_reference`), adds the bounce's work;
    with `uv`, the winner's uv."""
    draw = _draw_window(base, b)
    walk = None if counts is None else dict(nodes=0, rows=0, tri_nodes=0,
                                            tri_rows=0, tri_wins=0,
                                            leaf_tests=0, tri_leaf_tests=0,
                                            tri_read=None)
    h = _scene_hit(bake, o3, d3, tm, t_min, draw, n, dev, alive, walk, uv)
    hit = alive & (h.t < BIG * 0.5)
    miss = alive & ~(h.t < BIG * 0.5)
    sh = shading[h.idx]
    kind = sh[:, SH_KIND].to(torch.int32)
    front, n3, p3 = _surface(h, o3, d3)
    new_d, ok = _scatter(bake.material_kinds(), draw, kind, sh, front, n3, d3)
    cont = hit & ok & (kind != st.DIFFUSE_LIGHT)
    if counts is not None:
        counts["live"] += int(alive.sum())
        for k in ("nodes", "rows", "tri_nodes", "tri_rows", "tri_wins",
                  "leaf_tests", "tri_leaf_tests"):
            counts[k] += walk[k]
        counts["tri_read"] = merge_reads(counts["tri_read"], walk["tri_read"])
        lit = kind == st.DIFFUSE_LIGHT
        for k in torch.unique(kind[hit & ~lit]).tolist():
            counts["scatter"][k] = (counts["scatter"].get(k, 0)
                                    + int((hit & ~lit & (kind == k)).sum()))
    return _Bounce(hit, miss, cont, kind, sh, p3, new_d,
                   _resolve_uv(h) if uv else None), draw


def _advance(bn: _Bounce, o3: tuple, d3: tuple) -> tuple:
    """The next ray: origin moved to the hit point, the scattered
    direction, on the lanes that hit (:1549-1554)."""
    return (tuple(torch.where(bn.hit, p, o) for p, o in zip(bn.p3, o3)),
            tuple(torch.where(bn.hit, nd, d) for nd, d in zip(bn.d3, d3)))


def trace_pixels_reference(bake: SceneBake, camera, img_h: int, img_w: int,
                           pix_base: int, n: int, seed: int,
                           max_depth: int = 50, t_min: float = 0.001,
                           device: torch.device | str = "cpu",
                           rr_start: int = 0,
                           counts: Optional[dict] = None) -> torch.Tensor:
    """Forward radiance (n, 3) float32 for pixels [pix_base, pix_base + n)
    of an img_h x img_w image, camera rays made from the PCG stream, with
    russian roulette from bounce `rr_start` when it is > 0.

    The plain PyTorch version of `megakernel_fwd`, vectorized over the
    lanes of the call: every lane runs every bounce under an `alive` mask,
    and a dead lane adds nothing, so it matches a kernel thread that stops
    when its ray dies (pallas_trace.py:1397-1398, 1626-1637).

    `counts`, when given a dict, receives the work the kernel does for these
    paths: "live" bounces, "cont" bounces that go on, "scatter" {material
    kind: hits that scatter}, the sphere-BVH walk's "nodes" and "rows"
    tests and "leaf_tests" (`sphere_walk_reference`), and the triangle
    walk's "tri_nodes" and "tri_rows" tests, "tri_wins" and
    "tri_leaf_tests" (`tri_walk_reference`), and
    "tri_read", the union of the walks' `tri_reads` (None without
    triangles).
    """
    dev = torch.device(device)
    base = rng_base(n, seed, dev)
    o3, d3, tm = _camera_rays(camera, img_h, img_w, pix_base, n, base, dev)
    return _trace(bake, o3, d3, tm, base, max_depth, t_min, rr_start, counts)


def trace_rays_reference(bake: SceneBake, o: torch.Tensor, d: torch.Tensor,
                         tm: torch.Tensor, seed: int, max_depth: int = 50,
                         t_min: float = 0.001, rr_start: int = 0,
                         counts: Optional[dict] = None) -> torch.Tensor:
    """`trace_pixels_reference` on given rays (kernel 1c,
    `PallasTracer.__call__`): o, d (N, 3) and tm (N,) float32; lane i's
    random numbers are those of lane i of a camera-ray call with the same
    int32 seed.  Returns (N, 3) float32 radiance on the rays' device."""
    base = rng_base(o.shape[0], seed, o.device)
    return _trace(bake, tuple(o.unbind(1)), tuple(d.unbind(1)), tm, base,
                  max_depth, t_min, rr_start, counts)


def chunk_rows(img_h: int, img_w: int, ray_batch: int) -> int:
    """The rows of a sample chunk: img_h * img_w pixels rounded up to whole
    waves of `ray_batch` (rows past the image trace its last pixel)."""
    if img_h <= 0 or img_w <= 0 or ray_batch <= 0:
        raise ValueError(f"bad image {img_h}x{img_w} or ray_batch "
                         f"{ray_batch}")
    return -(-img_h * img_w // ray_batch) * ray_batch


def trace_chunk_reference(bake: SceneBake, camera, img_h: int, img_w: int,
                          base: int, spp: int, ray_batch: int,
                          max_depth: int = 50, t_min: float = 0.001,
                          device: torch.device | str = "cpu",
                          rr_start: int = 0,
                          counts: Optional[dict] = None) -> torch.Tensor:
    """One sample chunk's radiance sums, (chunk_rows, 3) float32: for s in
    0..spp-1 and each wave bid of `ray_batch` pixels, in that order,
    `trace_pixels_reference` of pixels [bid * b, (bid + 1) * b) with seed
    `wave_seed(base, s, bid)` added to the wave's rows of sums that start
    at 0.  The plain version of the chunk launch (`Tracer.bind_chunk`).

    Every lane's arithmetic is its own, so the waves' lanes go through one
    bounce loop together (one set of eager launches a bounce for the whole
    chunk, not one a wave), and their radiance is then added wave by wave
    in the per-wave order.  `counts` receives the chunk's work, as
    `trace_pixels_reference`'s does a wave's."""
    dev = torch.device(device)
    rows = chunk_rows(img_h, img_w, ray_batch)
    nb = rows // ray_batch
    o3, d3, tm, bases = _waves_rays(camera, img_h, img_w, base, ray_batch,
                                    nb, range(spp * nb), dev)
    rad = _trace(bake, o3, d3, tm, bases, max_depth, t_min, rr_start, counts)
    sums = torch.zeros((rows, 3), dtype=torch.float32, device=dev)
    for s in range(spp):
        sums += rad[s * rows:(s + 1) * rows]
    return sums


def _waves_rays(camera, img_h: int, img_w: int, base: int, ray_batch: int,
                nb: int, waves, dev: torch.device) -> tuple:
    """The camera rays and random streams of a chunk's waves, `waves` an
    iterable of wave numbers w in the schedule order (sample w // nb, wave
    w % nb of it, seeded `wave_seed(base, s, bid)`), lane after lane and
    wave after wave: (o3, d3, tm, rng bases)."""
    rays, bases = [], []
    for w in waves:
        s, bid = divmod(w, nb)
        b = rng_base(ray_batch, wave_seed(base, s, bid), dev)
        rays.append(_camera_rays(camera, img_h, img_w, bid * ray_batch,
                                 ray_batch, b, dev))
        bases.append(b)
    o3, d3 = (tuple(torch.cat([r[j][k] for r in rays]) for k in range(3))
              for j in range(2))
    return o3, d3, torch.cat([r[2] for r in rays]), torch.cat(bases)


def _zero_counts(counts: Optional[dict]) -> None:
    """Sets every work count of the plain versions' `counts` to 0."""
    if counts is not None:
        counts.update(live=0, cont=0, scatter={}, nodes=0, rows=0,
                      tri_nodes=0, tri_rows=0, tri_wins=0, leaf_tests=0,
                      tri_leaf_tests=0, tri_read=None)


def _trace(bake: SceneBake, o3: tuple, d3: tuple, tm: torch.Tensor,
           base: torch.Tensor, max_depth: int, t_min: float, rr_start: int,
           counts: Optional[dict]) -> torch.Tensor:
    """The forward bounce loop of both plain forward versions."""
    n, dev = tm.shape[0], tm.device
    t_min = _f32(t_min)
    shading = torch.as_tensor(bake.shading_table(), device=dev)
    tex_kinds = bake.texture_kinds()

    tr = torch.ones(n, dtype=torch.float32, device=dev)
    tg, tb = tr.clone(), tr.clone()
    lr, lg, lb = (torch.zeros(n, dtype=torch.float32, device=dev)
                  for _ in range(3))
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    bgr, bgg, bgb = bake.background
    _zero_counts(counts)

    for b in range(max_depth):
        if not bool(alive.any()):
            break
        bn, draw = _bounce(bake, shading, base, b, alive, o3, d3, tm, t_min,
                           n, dev, counts)
        ar, ag, ab = _albedo(tex_kinds, bn.sh, bn.p3)

        # ---- background on miss, emission on a light (:1432-1442) ----
        lr = lr + torch.where(bn.miss, tr * bgr, 0.0)
        lg = lg + torch.where(bn.miss, tg * bgg, 0.0)
        lb = lb + torch.where(bn.miss, tb * bgb, 0.0)
        lit = bn.hit & (bn.kind == st.DIFFUSE_LIGHT)
        lr = lr + torch.where(lit, tr * ar, 0.0)
        lg = lg + torch.where(lit, tg * ag, 0.0)
        lb = lb + torch.where(lit, tb * ab, 0.0)

        # ---- throughput, dielectric left out (:1515-1519) ----
        cont = bn.cont
        att = cont & (bn.kind != st.DIELECTRIC)
        tr = torch.where(att, tr * ar, tr)
        tg = torch.where(att, tg * ag, tg)
        tb = torch.where(att, tb * ab, tb)
        if rr_start > 0:
            # russian roulette (:1521-1534): from bounce rr_start a path
            # goes on with p = clip(max throughput, 0.05, 1), reweighted 1/p
            p = torch.clamp(torch.maximum(tr, torch.maximum(tg, tb)),
                            min=_RR_FLOOR, max=1.0)
            survive = (b < rr_start) | (uniform(draw, 8) < p)
            inv_p = torch.where((b >= rr_start) & survive & cont, 1.0 / p,
                                1.0)
            tr, tg, tb = tr * inv_p, tg * inv_p, tb * inv_p
            cont = cont & survive
        o3, d3 = _advance(bn, o3, d3)
        alive = cont
        if counts is not None:
            counts["cont"] += int(cont.sum())

    return torch.stack((lr, lg, lb), dim=-1)


def walk_packed_pixels_reference(bake: SceneBake, camera, img_h: int,
                                 img_w: int, pix_base: int, n: int,
                                 seed: int, max_depth: int = 50,
                                 t_min: float = 0.001,
                                 device: torch.device | str = "cpu"
                                 ) -> tuple:
    """Record planes for pixels [pix_base, pix_base + n): per bounce the
    packed word `mat | hit<<16 | cont<<17 | miss<<18` (pallas_trace.py:
    1536-1541), (max_depth, n) int32, and, when the scene needs them
    (`SceneBake.need_p`), the hit point's x, y and z, (max_depth, n)
    float32 each (:1542-1545), and (`SceneBake.need_uv`) the winner's u and
    v (:1546-1548); the same paths as `trace_pixels_reference` without
    russian roulette (the record mode has none).  Returns the tuple
    (packed[, px, py, pz][, u, v]), the JAX plane order (:1677).

    The plain PyTorch version of `megakernel_record`.  A lane whose path
    has ended records 0, as a kernel thread does; the Pallas kernel stores
    the stale `mat` of a dead lane's frozen ray there (with every mask bit
    0), so compare against it bits 16-18 everywhere and bits 0-15 only where
    bit 16 is set.  The hit point is o + t d where bit 16 is set and 0
    elsewhere, where the Pallas kernel leaves o + 1e30 d or a frozen ray's
    point; compare it only where bit 16 is set.  So is uv, which is 0
    elsewhere (`uv_agreement`).
    """
    dev = torch.device(device)
    base = rng_base(n, seed, dev)
    o3, d3, tm = _camera_rays(camera, img_h, img_w, pix_base, n, base, dev)
    return _walk(bake, o3, d3, tm, base, max_depth, t_min)


def walk_packed_reference(bake: SceneBake, o: torch.Tensor, d: torch.Tensor,
                          tm: torch.Tensor, seed: int, max_depth: int = 50,
                          t_min: float = 0.001) -> tuple:
    """`walk_packed_pixels_reference` on given rays (kernel 1c,
    `PallasTracer.walk_packed`): o, d (N, 3) and tm (N,) float32, lane i
    seeded as lane i of a camera-ray call with the same int32 seed."""
    base = rng_base(o.shape[0], seed, o.device)
    return _walk(bake, tuple(o.unbind(1)), tuple(d.unbind(1)), tm, base,
                 max_depth, t_min)


# The record planes one chunk launch writes at most (`record_groups`): a
# chunk whose planes would take more launches once a group of waves.
RECORD_CHUNK_BYTES = 4 << 30


def record_groups(waves: int, wave_bytes: int, budget: int) -> list:
    """A chunk's `waves` waves in the schedule order, split into groups of
    consecutive waves whose record planes (`wave_bytes` a wave) fit in
    `budget` bytes, one wave a group at the least: [(first, count), ...]."""
    if waves <= 0 or wave_bytes <= 0:
        raise ValueError(f"bad chunk: {waves} waves of {wave_bytes} bytes")
    per = max(1, budget // wave_bytes)
    return [(f, min(per, waves - f)) for f in range(0, waves, per)]


def walk_chunk_reference(bake: SceneBake, camera, img_h: int, img_w: int,
                         base: int, spp: int, ray_batch: int,
                         max_depth: int = 50, t_min: float = 0.001,
                         device: torch.device | str = "cpu",
                         first: int = 0, count: Optional[int] = None,
                         counts: Optional[dict] = None) -> tuple:
    """The record planes of waves [first, first + count) (default: all
    spp * nb) of a training chunk of `spp` samples of every pixel in waves
    of `ray_batch` pixels (nb = ceil(img_h * img_w / ray_batch) waves a
    sample), in the schedule order: wave w is sample w // nb, wave
    bid = w % nb of it, `walk_packed_pixels_reference` of pixels
    [bid * ray_batch, (bid + 1) * ray_batch) with seed
    `wave_seed(base, s, bid)`.  Returns (packed[, px, py, pz][, u, v]),
    each (count, max_depth, ray_batch), so plane[w - first] is wave w's
    (max_depth, ray_batch) plane, and for a whole chunk
    plane.view(spp, nb, max_depth, ray_batch)[s, bid].  The plain version
    of the record chunk launch (`Tracer.bind_record_chunk`).

    Every lane's arithmetic is its own, so the waves' lanes go through one
    bounce loop together, as `trace_chunk_reference`'s do.  `counts`
    receives the work of these paths, as `trace_pixels_reference`'s."""
    dev = torch.device(device)
    nb = -(-img_h * img_w // ray_batch) if ray_batch > 0 else 0
    waves = spp * nb
    count = waves - first if count is None else count
    if ray_batch <= 0 or spp <= 0 or not 0 <= first < first + count <= waves:
        raise ValueError(f"waves [{first}, {first + count}) of a chunk of "
                         f"{spp} x {nb} waves of {ray_batch}")
    o3, d3, tm, bases = _waves_rays(camera, img_h, img_w, base, ray_batch,
                                    nb, range(first, first + count), dev)
    planes = _walk(bake, o3, d3, tm, bases, max_depth, t_min, counts)
    return tuple(p.view(max_depth, count, ray_batch).transpose(0, 1)
                 .contiguous() for p in planes)


def _walk(bake: SceneBake, o3: tuple, d3: tuple, tm: torch.Tensor,
          base: torch.Tensor, max_depth: int, t_min: float,
          counts: Optional[dict] = None) -> tuple:
    """The record bounce loop of the plain record versions; `counts` as
    `trace_pixels_reference`'s (the same paths)."""
    n, dev = tm.shape[0], tm.device
    t_min = _f32(t_min)
    shading = torch.as_tensor(bake.shading_table(), device=dev)
    out = torch.zeros((max_depth, n), dtype=torch.int32, device=dev)
    p_out = (torch.zeros((3, max_depth, n), dtype=torch.float32, device=dev)
             if bake.need_p else None)
    uv_out = (torch.zeros((2, max_depth, n), dtype=torch.float32, device=dev)
              if bake.need_uv else None)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    _zero_counts(counts)

    for b in range(max_depth):
        if not bool(alive.any()):
            break
        bn, _ = _bounce(bake, shading, base, b, alive, o3, d3, tm, t_min, n,
                        dev, counts, uv=uv_out is not None)
        # hit, cont and miss as at pallas_trace.py:1397-1398, :1512-1513
        packed = (bn.sh[:, SH_MAT].to(torch.int32)
                  | (bn.hit.to(torch.int32) << 16)
                  | (bn.cont.to(torch.int32) << 17)
                  | (bn.miss.to(torch.int32) << 18))
        out[b] = torch.where(alive, packed, 0)
        if p_out is not None:
            for k in range(3):
                p_out[k, b] = torch.where(bn.hit, bn.p3[k], 0.0)
        if uv_out is not None:
            for k in range(2):
                uv_out[k, b] = torch.where(bn.hit, bn.uv[k], 0.0)
        o3, d3 = _advance(bn, o3, d3)
        alive = bn.cont
        if counts is not None:
            counts["cont"] += int(alive.sum())

    return ((out,) + (() if p_out is None else tuple(p_out.unbind(0)))
            + (() if uv_out is None else tuple(uv_out.unbind(0))))


def record_agreement(got, want, same_rays=None) -> dict:
    """How two stacks of record planes (..., max_depth, n) agree under the
    bit rule: bits 16-18 compared everywhere, bits 0-15 only where `want`
    has bit 16 set (a dead lane's mat bits carry nothing).

    Returns the fractions of entries whose masks agree (`mask_frac`), of
    hit entries whose mat agrees (`hit_mat_frac`), of lanes whose whole
    record agrees (`lane_frac`), of words equal bit for bit (`exact_frac`),
    and whether every lane agrees at bounce 0 (`first_bounce`) and
    everywhere (`bit_rule`).  `same_rays`, a (..., n) bool mask, limits
    `first_bounce` to the lanes whose first rays are known to be equal
    (`lens_cos_sin`).
    """
    got, want = _as_i64(got), _as_i64(want)
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} and "
                         f"{tuple(want.shape)}")
    agree = _lanes_agree(got, want)
    first = agree[..., 0, :]
    if same_rays is not None:
        first = first | ~torch.as_tensor(np.asarray(same_rays, bool))
    mask = HIT_BIT | CONT_BIT | MISS_BIT
    hit = (want & HIT_BIT) != 0
    mats = (got & 0xFFFF) == (want & 0xFFFF)
    return dict(mask_frac=float(((got & mask) == (want & mask)).double()
                                .mean()),
                hit_mat_frac=float(mats[hit].double().mean()) if hit.any()
                else 1.0,
                lane_frac=float(agree.all(-2).double().mean()),
                exact_frac=float((got == want).double().mean()),
                first_bounce=bool(first.all()),
                bit_rule=bool(agree.all()))


def _as_i64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.int64)
    return torch.from_numpy(np.array(x, dtype=np.int64))


def _as_f64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float64)
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _lanes_agree(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per entry, the bit rule: the mask bits equal, and the mat bits too
    where `want` hit."""
    mask = HIT_BIT | CONT_BIT | MISS_BIT
    hit = (want & HIT_BIT) != 0
    return (((got & mask) == (want & mask))
            & (((got & 0xFFFF) == (want & 0xFFFF)) | ~hit))


def p_agreement(got, want, got_p, want_p) -> dict:
    """How the hit-point planes of two record walks agree: got/want the
    packed planes (..., max_depth, n), got_p/want_p the hit points
    (..., 3, max_depth, n).  Over the entries where `want` hit (bit 16), on
    the lanes whose whole record agrees under the bit rule, with the error
    of an entry its largest component's: at bounce 0 the largest error
    (`max_err0`) and the fraction within HIT_CLOSE (`frac_close0`); over
    all bounces the largest error (`max_err`), the fraction within
    HIT_LIMITS["p"] (`frac_limit`) and the fraction of entries equal bit
    for bit (`exact_frac`).

    `hit_rule`: `hit_agreement`'s float rule at bounce 0, where it was set
    on camera rays (within HIT_LIMITS["p"], >= 99% within HIT_CLOSE), and
    >= 99% of all entries within HIT_LIMITS["p"].  After a bounce XLA's
    contracted sphere quadratic (up to ~1e-3 of p) turns a small sphere's
    normal, and the error grows along the path, so its largest value is
    not bounded there."""
    got, want = _as_i64(got), _as_i64(want)
    gp, wp = _as_f64(got_p), _as_f64(want_p)
    lanes = _lanes_agree(got, want).all(-2, keepdim=True)
    sel = ((want & HIT_BIT) != 0) & lanes                 # (..., D, n)
    err = (gp - wp).abs().amax(-3)                        # (..., D, n)
    e_all, e0 = err[sel], err[..., 0, :][sel[..., 0, :]]

    def frac(e, limit):
        return float((e <= limit).double().mean()) if len(e) else 1.0

    res = dict(entries=int(sel.sum()),
               max_err0=float(e0.max()) if len(e0) else 0.0,
               frac_close0=frac(e0, HIT_CLOSE),
               max_err=float(e_all.max()) if len(e_all) else 0.0,
               frac_limit=frac(e_all, HIT_LIMITS["p"]),
               exact_frac=frac(e_all, 0.0))
    res["hit_rule"] = (res["max_err0"] <= HIT_LIMITS["p"]
                       and res["frac_close0"] >= 0.99
                       and res["frac_limit"] >= 0.99)
    return res


def uv_agreement(got, want, got_uv, want_uv, limit0: float) -> dict:
    """How the uv planes of two record walks agree: got/want the packed
    planes (..., max_depth, n), got_uv/want_uv the uv planes (..., 2,
    max_depth, n).  Over the entries where `want` hit (bit 16), on the
    lanes whose whole record agrees under the bit rule, with an entry's
    error the larger of its u error, taken modulo 1 (a sphere's u wraps at
    its seam: an ulp of phase moves u from near 1 to near 0), and its v
    error: at bounce 0 the largest error (`max_err0`), the fraction within
    UV_CLOSE (`frac_close0`) and the fraction equal bit for bit
    (`exact0`); over all bounces the largest error (`max_err`), the
    fraction within HIT_CLOSE (`frac_limit`) and the fraction equal bit
    for bit (`exact_frac`).

    `rule`: at bounce 0 every entry within `limit0` (a golden's own, from
    UV_LIMIT0) and >= 99% within UV_CLOSE, and >= 99% of all entries
    within HIT_CLOSE.  XLA on the CPU contracts multiply-adds, so against
    the Pallas kernel uv is not bit-exact even at bounce 0 (a rect's hit
    coordinate, a sphere's normal); on the card the kernel equals its
    plain version bit for bit.  A uv plane rounded to bfloat16 (up to
    ~2e-3 on [0.5, 1)) fails the bounce-0 limits."""
    got, want = _as_i64(got), _as_i64(want)
    gu, wu = _as_f64(got_uv), _as_f64(want_uv)
    lanes = _lanes_agree(got, want).all(-2, keepdim=True)
    sel = ((want & HIT_BIT) != 0) & lanes                 # (..., D, n)
    du = (gu[..., 0, :, :] - wu[..., 0, :, :]).abs()
    du = torch.minimum(du, 1.0 - du)
    err = torch.maximum(du, (gu[..., 1, :, :] - wu[..., 1, :, :]).abs())
    e_all, e0 = err[sel], err[..., 0, :][sel[..., 0, :]]

    def frac(e, limit):
        return float((e <= limit).double().mean()) if len(e) else 1.0

    res = dict(entries=int(sel.sum()),
               max_err0=float(e0.max()) if len(e0) else 0.0,
               frac_close0=frac(e0, UV_CLOSE), exact0=frac(e0, 0.0),
               max_err=float(e_all.max()) if len(e_all) else 0.0,
               frac_limit=frac(e_all, HIT_CLOSE),
               exact_frac=frac(e_all, 0.0))
    res["rule"] = (res["max_err0"] <= limit0
                   and res["frac_close0"] >= 0.99
                   and res["frac_limit"] >= 0.99)
    return res


def lens_cos_sin(seed: int, n: int,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """(2, n) float32: cos and sin of the lens angle of lanes 0..n-1 of an
    in-kernel camera call with int32 seed `seed` (`_camera_rays`), as
    torch computes them on `device`.  Where they differ from another
    implementation's by an ulp, the lane's camera ray differs."""
    cdraw = (rng_base(n, seed, torch.device(device)) + _CAM_DRAW) & _M32
    theta = _TWO_PI * uniform(cdraw, 2)
    return torch.stack((torch.cos(theta), torch.sin(theta)))


class HitResult(NamedTuple):
    """One closest hit per ray, the contract of `PallasTracer.hit`."""

    packed: torch.Tensor  # (N,) int32 mat | hit<<16 | miss<<18 | front<<19
    #                       | is_tri<<20 | is_sph<<21; 0 on a dead lane
    p: torch.Tensor       # (N, 3) o + t d (t = 1e30 on a miss)
    u: torch.Tensor       # (N,) the winner's final uv
    v: torch.Tensor       # (N,)
    normal: torch.Tensor  # (N, 3) unit, faced against the ray
    slot: torch.Tensor    # (N,) float32 a triangle winner's slot, else 0


HIT_LIMITS = {"p": 5e-3, "u": 1e-2, "v": 1e-2, "normal": 3e-2}
HIT_CLOSE = 2e-3  # the error that >= 99% of hit lanes stay within
# `uv_agreement`'s bounce-0 limit for each Pallas golden of
# tests/data/torch_port, over its largest bounce-0 error against the plain
# walk (the same on the CPU and on the card): the probe 2.9e-5, the image
# mesh 1.7e-6, earth's camera chunk 4.6e-6 and its ray planes 1.1e-5; the
# 70 small image spheres 2.7e-4 (XLA's contracted sphere quadratic turns a
# small sphere's normal).  UV_CLOSE is what >= 99% of bounce-0 entries
# stay within.
UV_LIMIT0 = {"image_probe_uv32": 1e-4, "image_mesh_uv32": 1e-4,
             "earth_fused32": 1e-4, "earth_rays": 1e-4,
             "image_spheres_uv32": 1e-3}
UV_CLOSE = 1e-4


def hit_agreement(got, want) -> dict:
    """How two hit results agree.  `got` and `want` are HitResults or
    sequences (packed, p, u, v, normal, ...) of tensors or arrays.

    Returns whether the packed words are equal on every lane
    (`packed_equal`); over the lanes that hit, the largest error of each
    float output (`max_err`, u taken modulo 1), the fraction of those lanes
    within HIT_CLOSE in every output (`frac_close`) and whether every error
    is within HIT_LIMITS (`within_limits`); and the fraction of all float
    values equal bit for bit (`exact_frac`).  The hit rule against the JAX
    kernel is `packed_equal`, `within_limits` and `frac_close >= 0.99`:
    XLA on the CPU contracts multiply-adds into FMAs, which the sphere
    quadratic's cancellation turns into up to ~1e-3 of t."""
    def as_t(x):
        return (x.detach().cpu() if isinstance(x, torch.Tensor)
                else torch.from_numpy(np.array(x)))

    g, w = [as_t(x) for x in got[:5]], [as_t(x) for x in want[:5]]
    hit = (w[0] & HIT_BIT) != 0
    close = hit.clone()
    res = dict(packed_equal=bool(torch.equal(g[0].to(torch.int32),
                                             w[0].to(torch.int32))),
               max_err={}, within_limits=True)
    exact = total = 0
    for name, a, b in zip(HIT_LIMITS, g[1:], w[1:]):
        err = (a.double() - b.double()).abs()
        exact += int((a == b).sum())
        total += a.numel()
        err = err[hit]
        if name == "u":
            err = torch.minimum(err, 1.0 - err)
        if err.dim() == 2:  # p, normal: the largest component's
            err = err.amax(-1)
        res["max_err"][name] = float(err.max()) if len(err) else 0.0
        res["within_limits"] &= res["max_err"][name] <= HIT_LIMITS[name]
        close[hit] &= err <= HIT_CLOSE
    res["frac_close"] = (float(close.sum()) / max(int(hit.sum()), 1))
    res["exact_frac"] = exact / max(total, 1)
    res["hits"] = int(hit.sum())
    return res


def _atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Full-quadrant atan2 from the Abramowitz & Stegun 4.4.49 polynomial
    on [0, 1] (`pallas_trace._atan2_poly`, `_atan_unit`; |err| < 1e-5)."""
    ax, ay = x.abs(), y.abs()
    z = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay),
                                            min=_HI_FLOOR)
    z2 = z * z
    c0, c1, c2, c3, c4 = _ATAN_COEFFS
    r = z * (c0 + z2 * (c1 + z2 * (c2 + z2 * (c3 + z2 * c4))))
    r = torch.where(ay > ax, _HALF_PI - r, r)
    r = torch.where(x < 0.0, _PI - r, r)
    return torch.where(y < 0.0, -r, r)


def _acos_poly(x: torch.Tensor) -> torch.Tensor:
    """acos(x) = atan2(sqrt(1 - x^2), x) (`pallas_trace._acos_poly`)."""
    return _atan2_poly(torch.sqrt(torch.clamp(1.0 - x * x, min=0.0)), x)


def _mod1(x: torch.Tensor) -> torch.Tensor:
    """x mod 1 with the sign of the divisor, as `jnp.remainder`: the exact
    fmod, plus 1 where that is negative."""
    r = torch.fmod(x, 1.0)
    return torch.where(r < 0.0, r + 1.0, r)


def _sphere_uv(n3: tuple, phase: torch.Tensor) -> tuple:
    """A sphere's (u, v) from its pre-flip outward normal (get_sphere_uv,
    sphere.h:19-32) through the polynomial acos and atan2, with the
    rotate_y `phase` added to u and the sum wrapped to [0, 1)
    (pallas_trace.py:1400-1410, :2197-2201)."""
    nx, ny, nz = n3
    theta = _acos_poly(torch.clamp(-ny, -1.0, 1.0))
    phi = _atan2_poly(-nz, nx) + _PI
    return _mod1(phi * _INV_TWO_PI + phase), theta * _INV_PI


def _extent(hi: float, lo: float) -> float:
    """float32(max(hi - lo, 1e-12)): a uv divisor, a Python double in the
    JAX kernel (pallas_trace.py:1807, :1866, :970-974), so rounded once."""
    return _f32(max(hi - lo, 1e-12))


def _div(num: torch.Tensor, den: float) -> torch.Tensor:
    """num / den with den as a tensor: a CUDA kernel of torch multiplies
    by the reciprocal of a host scalar divisor, and the kernels divide."""
    return num / torch.full_like(num, den)


def hit_reference(bake: SceneBake, o: torch.Tensor, d: torch.Tensor,
                  tm: torch.Tensor, alive: torch.Tensor,
                  t_min: float = 0.001) -> HitResult:
    """One closest hit per ray over the baked rects, boxes and spheres
    (strict `<` in that order), then the triangle tier, intersection only:
    no shading, no scatter, no random numbers.  The plain PyTorch version
    of `rt_hit` (`pallas_trace._make_hit_kernel`, :1722-2235) for a scene
    without media.  The spheres are a dense loop over the rows, or under a
    sphere BVH `rt_hit`'s own walk (`sphere_walk_reference`, octant links).

    o, d: (N, 3) float32; tm: (N,) float32 shutter times; alive: (N,)
    bool.  A non-triangle winner's uv is final: a rect's or a box face's,
    or a sphere's from its pre-flip outward normal through the polynomial
    atan2/acos plus its rotate_y phase.  The triangles are walked in the
    packed tier (`tri_walk_reference`, octant threading), pruned by the
    closest non-triangle hit; a triangle wins when strictly closer (bit 20),
    and then u, v are its barycentric weights of vertices 1 and 2 and
    `slot` its slot (`tri_perm` maps it to the triangle), while the packed
    word's mat and front bits and the normal stay the closest non-triangle
    hit's, as the Pallas kernel leaves them (the resolve takes the
    triangle's from its attributes).  The normal is faced against the ray
    and normalized with 1 / sqrt (XLA's rsqrt on the CPU is within an ulp
    of it).  `slot` is 0 where no triangle wins; a dead lane is all zeros.
    """
    if bake.sphere_media or bake.box_media:
        raise ValueError("the hit kernel draws no random numbers: scenes "
                         "with media take the megakernel")
    dev, n = o.device, o.shape[0]
    t_min = _f32(t_min)
    o3 = (o[:, 0], o[:, 1], o[:, 2])
    d3 = (d[:, 0], d[:, 1], d[:, 2])
    ox, oy, oz = o3
    dx, dy, dz = d3
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    t2 = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    nx, ny, nz, uu, vv = zeros, zeros, zeros, zeros, zeros
    mat = torch.zeros(n, dtype=torch.int32, device=dev)
    sph = torch.zeros(n, dtype=torch.bool, device=dev)

    def take(better, t, n3, m, u_, v_):
        nonlocal t2, nx, ny, nz, mat, uu, vv, sph
        t2 = torch.where(better, t, t2)
        nx = torch.where(better, n3[0], nx)
        ny = torch.where(better, n3[1], ny)
        nz = torch.where(better, n3[2], nz)
        mat = torch.where(better, m, mat)
        uu = torch.where(better, u_, uu)
        vv = torch.where(better, v_, vv)
        sph = sph & ~better

    for prim in bake.rects:
        ax = prim["axis"]
        t = (prim["k"] - o3[ax]) / _guard(d3[ax])
        a_ax = 1 if ax == 0 else 0
        b_ax = 1 if ax == 2 else 2
        pa = o3[a_ax] + t * d3[a_ax]
        pb = o3[b_ax] + t * d3[b_ax]
        ok = ((t >= t_min) & (pa >= prim["a0"]) & (pa <= prim["a1"])
              & (pb >= prim["b0"]) & (pb <= prim["b1"]))
        n3 = [zeros, zeros, zeros]
        n3[ax] = torch.ones_like(zeros)
        take(ok & (t < t2), t, n3, prim["mat"],
             _div(pa - prim["a0"], _extent(prim["a1"], prim["a0"])),
             _div(pb - prim["b0"], _extent(prim["b1"], prim["b0"])))

    for prim in bake.boxes:
        (ox2, oy_t, oz2), (dx2, dz2) = _box_interval(prim, o3, d3)
        tnx, tfx, tny, tfy, tnz, tfz = _slabs(prim, ox2, oy_t, oz2, dx2, dy,
                                              dz2)
        tn = torch.maximum(torch.maximum(tnx, tny), tnz)
        tf = torch.minimum(torch.minimum(tfx, tfy), tfz)
        t = torch.where(tn >= t_min, tn, tf)
        ok = (tf > torch.clamp(tn, min=0.0)) & (t >= t_min)
        is_x = (t == tnx) | (t == tfx)
        is_y = (t == tny) | (t == tfy)
        exiting = t == tf
        sx = torch.where((dx2 >= 0) ^ exiting, -1.0, 1.0)
        sy = torch.where((dy >= 0) ^ exiting, -1.0, 1.0)
        sz = torch.where((dz2 >= 0) ^ exiting, -1.0, 1.0)
        nobj_x = torch.where(is_x, sx, 0.0)
        nobj_y = torch.where(~is_x & is_y, sy, 0.0)
        nobj_z = torch.where(~is_x & ~is_y, sz, 0.0)
        c, s = prim["cos"], prim["sin"]
        lo, hi = prim["bmin"], prim["bmax"]
        # per-face uv, as the reference's six rects (box.h:14-27)
        ua = _div(ox2 + t * dx2 - lo[0], _extent(hi[0], lo[0]))
        ub = _div(oy_t + t * dy - lo[1], _extent(hi[1], lo[1]))
        uc = _div(oz2 + t * dz2 - lo[2], _extent(hi[2], lo[2]))
        take(ok & (t < t2), t,
             (c * nobj_x + s * nobj_z, nobj_y, (-s) * nobj_x + c * nobj_z),
             prim["mat"], torch.where(is_x, ub, ua),
             torch.where(is_x | is_y, uc, ub))

    table = bake.sphere_table
    if len(bake.sph_hit_nodes):
        # `rt_hit`'s own walk (the octant links): a ray that grazes a node's
        # box can round out of it and miss a sphere the dense loop finds
        w = sphere_walk_reference(bake, o3, d3, tm, t_min, t2, alive,
                                  octant=True)
        hs = _sphere_hit(_SphereRows.of(table, dev), o3, d3, tm, w.better,
                         w.t, w.row)
    elif len(table):
        hs = _closest_sphere(table, o3, d3, tm, t_min, t2)
    if len(table):
        q = torch.as_tensor(table, device=dev)[hs.row]
        take(hs.better, hs.t, hs.normal,
             q[:, SPHERE_SH + SH_MAT].to(torch.int32),
             q[:, SPHERE_SH + SH_COLS], zeros)  # the mat, the uv phase
        sph = sph | hs.better

    if len(bake.tri_hit_nodes):
        tw = tri_walk_reference(bake, o3, d3, t_min, t2, alive, octant=True)
        tri = tw.better
        sph = sph & ~tri
        t2 = torch.where(tri, tw.t, t2)
    else:
        tri = torch.zeros_like(sph)
    hit = alive & (t2 < BIG * 0.5)
    miss = alive & ~(t2 < BIG * 0.5)
    if len(table):
        su, sv = _sphere_uv((nx, ny, nz), uu)
        uu = torch.where(sph, su, uu)
        vv = torch.where(sph, sv, vv)
    slot = zeros
    if len(bake.tri_hit_nodes):
        uu = torch.where(tri, tw.ub, uu)
        vv = torch.where(tri, tw.vb, vv)
        slot = torch.where(tri, tw.row.to(torch.float32), 0.0)
    front = (dx * nx + dy * ny + dz * nz) < 0.0
    flip = torch.where(front, 1.0, -1.0)
    nlen = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                        min=_NORM_FLOOR))
    normal = torch.stack((nx * flip * nlen, ny * flip * nlen,
                          nz * flip * nlen), dim=-1)
    packed = (mat | (hit.to(torch.int32) << 16) | (miss.to(torch.int32) << 18)
              | (front.to(torch.int32) << 19) | (tri.to(torch.int32) << 20)
              | (sph.to(torch.int32) << 21))
    p = torch.stack((ox + t2 * dx, oy + t2 * dy, oz + t2 * dz), dim=-1)
    live = alive[:, None]
    return HitResult(packed=torch.where(alive, packed, 0),
                     p=torch.where(live, p, 0.0),
                     u=torch.where(alive, uu, 0.0),
                     v=torch.where(alive, vv, 0.0),
                     normal=torch.where(live, normal, 0.0),
                     slot=torch.where(alive, slot, 0.0))


# --------------------------------------------------------------------------
# the kernel wrapper
# --------------------------------------------------------------------------


def launch_counts() -> dict:
    """The `Tracer` launch counts by the C entry each one counts (kernel
    rows 1a-1d and 2: `rt_trace_pixels`, `rt_trace_chunk`,
    `rt_walk_packed_pixels`, `rt_walk_chunk`, `rt_trace_rays`,
    `rt_walk_packed`, `rt_hit`)."""
    t = Tracer
    return {"rt_trace_pixels": t.launches, "rt_trace_chunk": t.chunk_launches,
            "rt_walk_packed_pixels": t.record_launches,
            "rt_walk_chunk": t.record_chunk_launches,
            "rt_trace_rays": t.ray_launches - t.walk_ray_launches,
            "rt_walk_packed": t.walk_ray_launches, "rt_hit": t.hit_launches}


def reset_launch_counts() -> None:
    """Every `Tracer` launch count to 0."""
    for name in ("launches", "chunk_launches", "record_launches",
                 "record_chunk_launches", "ray_launches", "walk_ray_launches",
                 "hit_launches"):
        setattr(Tracer, name, 0)


def _require_cuda(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}: use 'cpu' or 'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           "torch.cuda.is_available() is False")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.rt_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _check_count(n: int) -> None:
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")


def _check_table(t: torch.Tensor, cols: int, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> None:
    """A kernel table: contiguous, (rows, cols) of `dtype` on `device`, and
    16-byte aligned (the kernels read BVH nodes, triangle slots and sphere
    rows 16 bytes at a time)."""
    if (t.device != device or t.dtype != dtype
            or not t.is_contiguous() or t.dim() != 2 or t.shape[1] != cols
            or t.data_ptr() % 16 != 0):
        raise ValueError(f"kernel table must be a contiguous, 16-byte "
                         f"aligned {dtype} (rows, {cols}) tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device} at {t.data_ptr():#x}")


def _check_rays(o: torch.Tensor, d: torch.Tensor, tm: torch.Tensor,
                alive: Optional[torch.Tensor], device: torch.device) -> int:
    """The ray count N of a hit query or a ray-plane launch, after checking
    the planes: o, d contiguous float32 (N, 3), tm float32 (N,), alive bool
    (N,) when given, all on `device`."""
    n = o.shape[0] if o.dim() == 2 else -1
    for name, t, shape, dtype in (("o", o, (n, 3), torch.float32),
                                  ("d", d, (n, 3), torch.float32),
                                  ("tm", tm, (n,), torch.float32),
                                  ("alive", alive, (n,), torch.bool)):
        if t is None:
            continue
        if (t.device != device or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                             f"tensor on {device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    _check_count(n)
    if n > 2**31 - 1:
        raise ValueError(f"{n} rays do not fit int32")
    return n


def _ray_planes(o: torch.Tensor, d: torch.Tensor,
                tm: torch.Tensor) -> torch.Tensor:
    """The (7, N) float32 ray planes o xyz, d xyz, tm that the ray-plane
    entries read (`RtParams.rays`)."""
    rays = torch.empty((7, o.shape[0]), dtype=torch.float32, device=o.device)
    rays[0:3] = o.T
    rays[3:6] = d.T
    rays[6] = tm
    return rays


class Tracer:
    """Scene-specialized tracer on one device: forward radiance, the record
    walk and the pure closest hit.  `jax_tri_stream` (of `bake`) is the JAX
    package's mesh routing predicate (`engine.render.route`); `need_p` and
    `need_uv` say which planes the record walk writes beside the packed
    one (`PallasTracer.need_p`, `need_uv`).

    On a CUDA device `trace_pixels`, `__call__`, `walk_packed_pixels`,
    `walk_packed`, `hit` and the chunks of `bind_chunk` and
    `bind_record_chunk` launch the kernels (`csrc/megakernel.cuh`,
    `csrc/hit.cu`); on the CPU they run `trace_pixels_reference`,
    `trace_rays_reference`, `walk_packed_pixels_reference`,
    `walk_packed_reference`, `hit_reference`, `trace_chunk_reference` and
    `walk_chunk_reference`.  Nothing falls back from
    one to the other.  The constructor raises NotImplementedError for a
    scene no kernel covers (`unported_feature`), the forward entries
    (`trace_pixels`, `__call__`) ValueError for an image-textured scene
    (`supports_forward`: it takes the record walk), and `hit` ValueError
    for one with media (`supports_hit`).
    """

    launches = 0         # megakernel_fwd launches on one wave, all tracers
    chunk_launches = 0   # megakernel_fwd launches on a whole sample chunk
    record_launches = 0  # megakernel_record launches on one camera-ray wave
    record_chunk_launches = 0  # megakernel_record launches on chunk waves
    ray_launches = 0     # launches of both modes on ray planes (kernel 1c)
    walk_ray_launches = 0  # the record mode's share of them
    hit_launches = 0     # rt_hit launches

    def __init__(self, scene: st.Scene, device: torch.device | str):
        feature = unported_feature(scene)
        if feature is not None:
            raise NotImplementedError(f"{feature}: not yet ported")
        self.device = torch.device(device)
        if self.device.type != "cpu":
            _require_cuda(self.device)
            if self.device.index is None:
                # tensors report cuda:N, and the wrappers compare devices
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self.bake = bake = bake_scene(scene)
        self.need_p, self.need_uv = bake.need_p, bake.need_uv
        self.supports_forward = supports_forward(scene)
        (self.rect_table, self.box_table, self.sphere_table,
         self.media_table, self.tri_table) = (
            torch.as_tensor(t, device=self.device) for t in (
                bake.rect_table(), bake.box_table(), bake.sphere_table,
                bake.media_table(), bake.tri_table))
        # the BVHs as the kernels read them (`device_tables`): node
        # records, link pairs, the hit tier's 48-byte slots
        for name, t in device_tables(bake).items():
            setattr(self, name, torch.as_tensor(t, device=self.device))
        # the hit kernel draws no random numbers, so no media
        # (pallas_trace.py:2372-2387; the VMEM budget has no meaning here)
        self.supports_hit = not (bake.sphere_media or bake.box_media)
        self.world_lo, self.world_hi = bake.world_bounds()

    def trace_pixels(self, camera, img_h: int, img_w: int, pix_base: int,
                     n: int, seed: int, max_depth: int = 50,
                     t_min: float = 0.001, rr_start: int = 0) -> torch.Tensor:
        """Forward radiance (n, 3) float32 on the tracer's device for
        pixels [pix_base, pix_base + n), with the camera rays made from the
        kernel's PCG stream (contract of `PallasTracer.trace_pixels`).
        Pixel ids past the image clamp to its last pixel; `seed` is an
        int32 (`wave_seed`); russian roulette from bounce `rr_start` when it
        is > 0."""
        return self.bind(camera, img_h, img_w, max_depth, t_min,
                         rr_start)(pix_base, n, seed)

    def __call__(self, o: torch.Tensor, d: torch.Tensor, tm: torch.Tensor,
                 seed: int, max_depth: int = 50, t_min: float = 0.001,
                 rr_start: int = 0) -> torch.Tensor:
        """Forward radiance (N, 3) float32 of given rays (contract of
        `PallasTracer.__call__`, kernel 1c): o, d (N, 3) and tm (N,)
        float32, contiguous on the tracer's device.  `seed` is the int32
        that the JAX package draws from its key (`_tile_args`)."""
        return self.bind_trace_rays(max_depth, t_min, rr_start)(o, d, tm,
                                                                seed)

    def walk_packed_pixels(self, camera, img_h: int, img_w: int,
                           pix_base: int, n: int, seed: int,
                           max_depth: int = 50,
                           t_min: float = 0.001) -> tuple:
        """Record planes on the tracer's device for pixels
        [pix_base, pix_base + n) (contract of
        `PallasTracer.walk_packed_pixels`, cropped to n lanes): the packed
        word `mat | hit<<16 | cont<<17 | miss<<18` per bounce, (max_depth,
        n) int32, then, when `need_p`, px, py and pz, and when `need_uv`,
        u and v, (max_depth, n) float32 each.  A bounce after the path's
        end is 0 in every plane, and so are a miss's hit point and uv."""
        return self.bind_record(camera, img_h, img_w, max_depth, t_min)(
            pix_base, n, seed)

    def walk_packed(self, o: torch.Tensor, d: torch.Tensor, tm: torch.Tensor,
                    seed: int, max_depth: int = 50,
                    t_min: float = 0.001) -> tuple:
        """The record planes of `walk_packed_pixels` for given rays
        (contract of `PallasTracer.walk_packed`, kernel 1c): o, d (N, 3)
        and tm (N,) float32, contiguous on the tracer's device; `seed` as
        in `__call__`."""
        return self.bind_walk_packed(max_depth, t_min)(o, d, tm, seed)

    def walk(self, o: torch.Tensor, d: torch.Tensor, tm: torch.Tensor,
             seed: int, max_depth: int = 50, t_min: float = 0.001):
        """`walk_packed` as `engine.integrator.BounceData`
        (`PallasTracer.walk`)."""
        from ..engine.integrator import unpack_walk

        return unpack_walk(self.walk_packed(o, d, tm, seed, max_depth, t_min),
                           self.need_p, self.need_uv)

    def bind(self, camera, img_h: int, img_w: int, max_depth: int = 50,
             t_min: float = 0.001, rr_start: int = 0
             ) -> Callable[[int, int, int], torch.Tensor]:
        """`trace_pixels` with the camera, image size, depth, t_min and
        rr_start fixed: returns `launch(pix_base, n, seed) -> (n, 3)`.  The
        tables are checked and the launch constants computed here, once, so
        a render's host work per wave is the output allocation and the
        launch."""
        self._require_forward()
        if self.device.type == "cpu":
            def plain(pix_base: int, n: int, seed: int) -> torch.Tensor:
                _check_count(n)
                return trace_pixels_reference(self.bake, camera, img_h, img_w,
                                              pix_base, n, seed, max_depth,
                                              t_min, self.device, rr_start)
            return plain

        tables, device = self._checked_tables(), self.device
        p, check_range = self._launch_params(
            camera, img_h, img_w, max_depth, t_min, rr_start,
            self.bake.features())
        lib = build.load()

        def launch(pix_base: int, n: int, seed: int) -> torch.Tensor:
            check_range(pix_base, n)
            out = torch.empty((n, 3), dtype=torch.float32, device=device)
            p.pix_base, p.n, p.seed = int(pix_base), int(n), _int32(seed)
            with torch.cuda.device(device):
                rc = lib.rt_trace_pixels(tables, p, out.data_ptr(),
                                         _stream(device))
            _check(lib, rc, "rt_trace_pixels")
            Tracer.launches += 1
            return out

        launch.tables = tables  # the kernel reads them through pointers
        return launch

    def bind_chunk(self, camera, img_h: int, img_w: int, max_depth: int,
                   t_min: float, rr_start: int, ray_batch: int,
                   spp_per_chunk: int) -> Callable[[int], torch.Tensor]:
        """One sample chunk in one launch: returns `launch(base) ->
        (chunk_rows, 3)` float32 sums over `spp_per_chunk` samples of every
        pixel in waves of `ray_batch` pixels, wave (s, bid) seeded
        `wave_seed(base, s, bid)`, equal bit for bit to those waves'
        `trace_pixels` added in order (`trace_chunk_reference`, which the
        CPU runs).  On the card the grid is what the card holds resident
        of the scene's instantiation (`occupancy`: blocks an SM, SMs,
        blocks), computed here once."""
        self._require_forward()
        rows = chunk_rows(img_h, img_w, ray_batch)
        if spp_per_chunk <= 0:
            raise ValueError(f"spp_per_chunk must be positive, got "
                             f"{spp_per_chunk}")
        if self.device.type == "cpu":
            def plain(base: int) -> torch.Tensor:
                return trace_chunk_reference(
                    self.bake, camera, img_h, img_w, base, spp_per_chunk,
                    ray_batch, max_depth, t_min, self.device, rr_start)
            return plain

        tables, device = self._checked_tables(), self.device
        p, check_range = self._launch_params(
            camera, img_h, img_w, max_depth, t_min, rr_start,
            self.bake.features())
        check_range(0, rows)
        p.n, p.wave, p.spp = rows, int(ray_batch), int(spp_per_chunk)
        lib = build.load()
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.rt_trace_occupancy(tables, p, ctypes.addressof(per_sm))
        _check(lib, rc, "rt_trace_occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        p.grid = per_sm.value * sms
        if p.grid <= 0:
            raise RuntimeError("rt_trace_occupancy: the forward kernel fits "
                               "no block on an SM")

        def launch(base: int) -> torch.Tensor:
            # the sums, then the kernel's 4-byte row counter
            out = torch.empty(3 * rows + 1, dtype=torch.float32,
                              device=device)
            p.seed = _int32(base)
            ptr = out.data_ptr()
            with torch.cuda.device(device):
                rc = lib.rt_trace_chunk(tables, p, ptr, ptr + 12 * rows,
                                        _stream(device))
            _check(lib, rc, "rt_trace_chunk")
            Tracer.chunk_launches += 1
            return out[:3 * rows].view(rows, 3)

        launch.tables = tables  # the kernel reads them through pointers
        launch.occupancy = (per_sm.value, sms, p.grid)
        return launch

    def bind_trace_rays(self, max_depth: int = 50, t_min: float = 0.001,
                        rr_start: int = 0
                        ) -> Callable[..., torch.Tensor]:
        """`__call__` with the depth, t_min and rr_start fixed: returns
        `launch(o, d, tm, seed) -> (N, 3)`."""
        self._require_forward()
        if self.device.type == "cpu":
            def plain(o, d, tm, seed: int) -> torch.Tensor:
                _check_rays(o, d, tm, None, self.device)
                return trace_rays_reference(self.bake, o, d, tm, seed,
                                            max_depth, t_min, rr_start)
            return plain

        tables, device = self._checked_tables(), self.device
        p, _ = self._launch_params(None, 1, 1, max_depth, t_min, rr_start,
                                   self.bake.features())
        lib = build.load()

        def launch(o, d, tm, seed: int) -> torch.Tensor:
            n = _check_rays(o, d, tm, None, device)
            rays = _ray_planes(o, d, tm)
            out = torch.empty((n, 3), dtype=torch.float32, device=device)
            p.n, p.seed = n, _int32(seed)
            with torch.cuda.device(device):
                rc = lib.rt_trace_rays(tables, p, rays.data_ptr(),
                                       out.data_ptr(), _stream(device))
            _check(lib, rc, "rt_trace_rays")
            Tracer.ray_launches += 1
            return out

        launch.tables = tables
        return launch

    def bind_record(self, camera, img_h: int, img_w: int,
                    max_depth: int = 50, t_min: float = 0.001
                    ) -> Callable[[int, int, int], tuple]:
        """`walk_packed_pixels` with the camera, image size, depth and t_min
        fixed: returns `launch(pix_base, n, seed) -> planes`, with the
        launch constants computed once, as `bind` does."""
        if self.device.type == "cpu":
            def plain(pix_base: int, n: int, seed: int) -> tuple:
                _check_count(n)
                return walk_packed_pixels_reference(
                    self.bake, camera, img_h, img_w, pix_base, n, seed,
                    max_depth, t_min, self.device)
            return plain

        p, check_range = self._launch_params(
            camera, img_h, img_w, max_depth, t_min, 0, self._record_features())
        walk = self._bind_walk(p, "rt_walk_packed_pixels")

        def launch(pix_base: int, n: int, seed: int) -> tuple:
            check_range(pix_base, n)
            p.pix_base = int(pix_base)
            planes = walk(n, seed)
            Tracer.record_launches += 1
            return planes

        launch.tables = walk.tables
        return launch

    def bind_record_chunk(self, camera, img_h: int, img_w: int,
                          max_depth: int, t_min: float, ray_batch: int,
                          spp_per_chunk: int) -> Callable[..., tuple]:
        """A training chunk's record walk in one launch a group of waves:
        returns `launch(base, first=0, count=None) -> planes` of waves
        [first, first + count) of the chunk's spp_per_chunk * nb waves of
        `ray_batch` pixels in the schedule order (nb waves a sample; wave
        w is sample w // nb, wave w % nb, seeded `wave_seed(base, s,
        bid)`), each plane (count, max_depth, ray_batch), equal bit for bit
        to those waves' `walk_packed_pixels` stacked
        (`walk_chunk_reference`, which the CPU runs).  `launch.groups`
        splits the chunk into runs of consecutive waves whose planes take
        at most RECORD_CHUNK_BYTES, one launch each; `launch.nb` is nb.  On
        the
        card the grid is what the card holds resident of the scene's record
        instantiation (`occupancy`: blocks an SM, SMs, blocks)."""
        if ray_batch <= 0 or spp_per_chunk <= 0:
            raise ValueError(f"bad ray_batch {ray_batch} or spp_per_chunk "
                             f"{spp_per_chunk}")
        nb = chunk_rows(img_h, img_w, ray_batch) // ray_batch
        waves = spp_per_chunk * nb
        entry_bytes = 4 * (1 + 3 * self.need_p + 2 * self.need_uv)
        groups = record_groups(waves, entry_bytes * max_depth * ray_batch,
                               RECORD_CHUNK_BYTES)

        def check(first: int, count: Optional[int]) -> int:
            count = waves - first if count is None else count
            if not 0 <= first < first + count <= waves:
                raise ValueError(f"waves [{first}, {first + count}) of a "
                                 f"chunk of {waves}")
            return count

        if self.device.type == "cpu":
            def plain(base: int, first: int = 0,
                      count: Optional[int] = None) -> tuple:
                return walk_chunk_reference(
                    self.bake, camera, img_h, img_w, base, spp_per_chunk,
                    ray_batch, max_depth, t_min, self.device, first,
                    check(first, count))
            plain.groups, plain.nb = groups, nb
            return plain

        tables, device = self._checked_tables(), self.device
        p, check_range = self._launch_params(
            camera, img_h, img_w, max_depth, t_min, 0, self._record_features())
        check_range(0, nb * ray_batch)
        p.n, p.wave, p.waves = nb * ray_batch, int(ray_batch), nb
        lib = build.load()
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.rt_walk_occupancy(tables, p, ctypes.addressof(per_sm))
        _check(lib, rc, "rt_walk_occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        p.grid = per_sm.value * sms
        if p.grid <= 0:
            raise RuntimeError("rt_walk_occupancy: the record kernel fits no "
                               "block on an SM")
        need_p, need_uv = self.need_p, self.need_uv

        def launch(base: int, first: int = 0,
                   count: Optional[int] = None) -> tuple:
            count = check(first, count)
            n = count * ray_batch
            if n + p.grid * 128 > 2**31 - 1:  # the kernel's int32 claims
                raise ValueError(f"{count} waves of {ray_batch} rays do not "
                                 "fit int32")
            # the packed plane, then the kernel's 4-byte ray counter
            packed = torch.empty(n * max_depth + 1, dtype=torch.int32,
                                 device=device)
            pf = torch.empty((3 * need_p + 2 * need_uv, count, max_depth,
                              ray_batch), dtype=torch.float32, device=device)
            planes = pf.unbind(0)
            ptrs = ([x.data_ptr() for x in planes[:3]] if need_p
                    else [None] * 3)
            ptrs += ([x.data_ptr() for x in planes[-2:]] if need_uv
                     else [None] * 2)
            p.n, p.wave0, p.seed = n, int(first), _int32(base)
            ptr = packed.data_ptr()
            with torch.cuda.device(device):
                rc = lib.rt_walk_chunk(tables, p, ptr, *ptrs,
                                       ptr + 4 * n * max_depth,
                                       _stream(device))
            _check(lib, rc, "rt_walk_chunk")
            Tracer.record_chunk_launches += 1
            return (packed[:n * max_depth].view(count, max_depth, ray_batch),
                    *planes)

        launch.tables = tables  # the kernel reads them through pointers
        launch.groups, launch.nb = groups, nb
        launch.occupancy = (per_sm.value, sms, p.grid)
        return launch

    def bind_walk_packed(self, max_depth: int = 50, t_min: float = 0.001
                         ) -> Callable[..., tuple]:
        """`walk_packed` with the depth and t_min fixed: returns
        `launch(o, d, tm, seed) -> planes`."""
        if self.device.type == "cpu":
            def plain(o, d, tm, seed: int) -> tuple:
                _check_rays(o, d, tm, None, self.device)
                return walk_packed_reference(self.bake, o, d, tm, seed,
                                             max_depth, t_min)
            return plain

        p, _ = self._launch_params(None, 1, 1, max_depth, t_min, 0,
                                   self._record_features())
        walk = self._bind_walk(p, "rt_walk_packed")

        def launch(o, d, tm, seed: int) -> tuple:
            n = _check_rays(o, d, tm, None, self.device)
            planes = walk(n, seed, _ray_planes(o, d, tm))
            Tracer.ray_launches += 1
            Tracer.walk_ray_launches += 1
            return planes

        launch.tables = walk.tables
        return launch

    def _require_forward(self) -> None:
        if not self.supports_forward:
            raise ValueError("image texture: the forward kernel shades no "
                             "image texture (its atlas is read by the torch "
                             "shade); the scene takes the record walk")

    def _record_features(self) -> int:
        """The record instantiation's bits: geometry and triangles only
        (the record mode evaluates no albedo)."""
        return self.bake.features() & (FEAT_SPHERES | FEAT_MEDIA
                                       | FEAT_SPHERE_BVH | FEAT_TRI_BVH)

    def _bind_walk(self, p, entry: str) -> Callable[..., tuple]:
        """One record launch through C entry `entry` with the parameter
        block `p`: `walk(n, seed[, rays]) -> planes`, the packed plane and,
        when `need_p`, the hit-point planes, and when `need_uv`, the uv
        planes."""
        tables, device = self._checked_tables(), self.device
        need_p, need_uv = self.need_p, self.need_uv
        lib = build.load()
        fn, depth = getattr(lib, entry), p.max_depth

        def walk(n: int, seed: int, *rays: torch.Tensor) -> tuple:
            p.n, p.seed = int(n), _int32(seed)
            out = torch.empty((depth, n), dtype=torch.int32, device=device)
            pf = torch.empty((3 * need_p + 2 * need_uv, depth, n),
                             dtype=torch.float32, device=device)
            planes = pf.unbind(0)
            ptrs = ([x.data_ptr() for x in planes[:3]] if need_p
                    else [None] * 3)
            ptrs += ([x.data_ptr() for x in planes[-2:]] if need_uv
                     else [None] * 2)
            with torch.cuda.device(device):
                rc = fn(tables, p, *(r.data_ptr() for r in rays),
                        out.data_ptr(), *ptrs, _stream(device))
            _check(lib, rc, entry)
            return (out, *planes)

        walk.tables = tables
        return walk

    def bind_hit(self, t_min: float = 0.001
                 ) -> Callable[..., HitResult]:
        """`hit` with t_min fixed: returns `launch(o, d, tm, alive) ->
        HitResult`, with the tables checked once."""
        if not self.supports_hit:
            raise ValueError("the hit kernel takes no media; this scene "
                             "takes the megakernel")
        t_min = _f32(t_min)
        if self.device.type == "cpu":
            def plain(o, d, tm, alive) -> HitResult:
                _check_rays(o, d, tm, alive, self.device)
                return hit_reference(self.bake, o, d, tm, alive, t_min)
            return plain

        tables = (self.rect_table, self.box_table, self.sphere_table,
                  self.sph_nodes, self.sph_octant_links, self.tri_slots,
                  self.tri_slot_nodes, self.tri_slot_links)
        f32, i32 = torch.float32, torch.int32
        for t, cols, dtype in zip(
                tables, (RECT_COLS, BOX_COLS, SPHERE_COLS, NODE_REC_COLS, 16,
                         TRI_SLOT_COLS, NODE_REC_COLS, 16),
                (f32,) * 4 + (i32, f32, f32, i32)):
            _check_table(t, cols, self.device, dtype)
        ptrs = tuple(t.data_ptr() for t in tables)
        counts = (len(self.bake.rects), len(self.bake.boxes),
                  len(self.bake.sphere_table), len(self.bake.sph_hit_nodes),
                  len(self.bake.tri_geom), len(self.bake.tri_hit_nodes))
        device, lib = self.device, build.load()

        def launch(o, d, tm, alive) -> HitResult:
            n = _check_rays(o, d, tm, alive, device)
            packed = torch.empty(n, dtype=torch.int32, device=device)
            f = torch.empty((3, n), dtype=torch.float32, device=device)
            p = torch.empty((n, 3), dtype=torch.float32, device=device)
            normal = torch.empty((n, 3), dtype=torch.float32, device=device)
            with torch.cuda.device(device):
                rc = lib.rt_hit(*ptrs, *counts, n, t_min, o.data_ptr(),
                                d.data_ptr(), tm.data_ptr(), alive.data_ptr(),
                                packed.data_ptr(), p.data_ptr(),
                                f[0].data_ptr(), f[1].data_ptr(),
                                normal.data_ptr(), f[2].data_ptr(),
                                _stream(device))
            _check(lib, rc, "rt_hit")
            Tracer.hit_launches += 1
            return HitResult(packed, p, f[0], f[1], normal, f[2])

        launch.tables = tables  # the kernel reads them through ptrs
        return launch

    def hit(self, o: torch.Tensor, d: torch.Tensor, tm: torch.Tensor,
            alive: torch.Tensor, t_min: float = 0.001) -> HitResult:
        """One closest hit per ray (contract of `PallasTracer.hit`, see
        `hit_reference`): o, d (N, 3) float32, tm (N,) float32 and alive
        (N,) bool, contiguous on the tracer's device."""
        return self.bind_hit(t_min)(o, d, tm, alive)

    def _checked_tables(self) -> "build.RtTables":
        """The megakernels' nine tables, checked, as the struct the C
        entries take.  It keeps the tensors alive (`.tensors`): a bound
        launch may outlive the tracer (`compile_renderer`)."""
        tensors = (self.rect_table, self.box_table, self.sphere_table,
                   self.media_table, self.sph_nodes, self.sph_links,
                   self.tri_table, self.tri_nodes, self.tri_links)
        f32, i32 = torch.float32, torch.int32
        for t, cols, dtype in zip(
                tensors, (RECT_COLS, BOX_COLS, SPHERE_COLS, MEDIUM_COLS,
                          NODE_REC_COLS, 2, TRI_COLS, NODE_REC_COLS, 2),
                (f32,) * 5 + (i32, f32, f32, i32)):
            _check_table(t, cols, self.device, dtype)
        tables = build.RtTables(*(t.data_ptr() for t in tensors))
        tables.tensors = tensors
        return tables

    def _launch_params(self, camera, img_h: int, img_w: int, max_depth: int,
                       t_min: float, rr_start: int, features: int):
        """The kernels' parameter block for a bound camera and image (or,
        with `camera` None, for ray planes: no camera, a 1 x 1 image), with
        the per-launch fields left to fill, and the check of a launch's
        pixel range."""
        if camera is None:
            zero3 = (0.0, 0.0, 0.0)
            (corg, cllc, chor, cver, cuv, cvv, clr, ct0, ct1) = (
                (zero3,) * 6 + (0.0, 0.0, 0.0))
        else:
            (corg, cllc, chor, cver, cuv, cvv, clr, ct0, ct1,
             img_h, img_w) = _cam_tuple(camera, img_h, img_w)
        if img_h <= 0 or img_w <= 0 or max_depth < 0 or rr_start < 0:
            raise ValueError(f"bad image {img_h}x{img_w}, depth {max_depth} "
                             f"or rr_start {rr_start}")
        c3 = ctypes.c_float * 3
        p = build.RtParams(
            origin=c3(*corg), llc=c3(*cllc), hor=c3(*chor), ver=c3(*cver),
            cu=c3(*cuv), cv=c3(*cvv), lens_radius=clr,
            inv_w=_inv_extent(img_w), inv_h=_inv_extent(img_h),
            t_min=_f32(t_min), bg=c3(*self.bake.background),
            time0=_f32(ct0), time_span=_f32(ct1 - ct0),
            img_h=img_h, img_w=img_w, max_depth=int(max_depth),
            n_rects=len(self.bake.rects), n_boxes=len(self.bake.boxes),
            n_spheres=len(self.bake.sphere_table),
            n_sph_nodes=len(self.bake.sph_nodes),
            n_tri_rows=len(self.bake.tri_table),
            n_tri_nodes=len(self.bake.tri_nodes),
            n_sphere_media=len(self.bake.sphere_media),
            n_box_media=len(self.bake.box_media), has_time=int(ct1 != ct0),
            rr_start=int(rr_start), features=int(features))

        def check_range(pix_base: int, n: int) -> None:
            _check_count(n)
            # the kernels compute pixel ids and img_h * img_w in int32
            if pix_base < 0 or max(pix_base + n, img_h * img_w) > 2**31 - 1:
                raise ValueError(f"pixel range [{pix_base}, {pix_base + n}) "
                                 f"of a {img_h}x{img_w} image does not fit "
                                 "int32")

        return p, check_range
