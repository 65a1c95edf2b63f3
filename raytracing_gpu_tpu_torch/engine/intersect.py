"""Closest hit over the packed primitive tables, in torch ops.

Counterpart of `raytracing_gpu_tpu/engine/intersect.py`, the XLA engine's
intersection: for a whole ray batch every primitive of a type is tested as
one broadcast expression (rays x primitives), an argmin keeps each ray's
closest, and only then is the winner's record (normal, uv, material)
computed.  Above the builder's threshold the spheres and triangles are
walked under their BVHs instead (`accel.traverse`).  Constant media are
resolved after the solids: each boundary's interval is clipped to the
closest solid hit and an exponential free path is drawn
(`constant_medium.h:34-70`).

The media's uniforms come from a `torch.Generator`, or are given
(`MediaDraws`), for example the JAX package's own threefry draws, which
the port does not reproduce.  This engine serves what the kernels refuse
(`ops.cuda_trace.unported_feature`) and is an oracle for them that shares
no code with them: the kernels' intersection is `ops/cuda_trace.py`'s
plain versions and `ops/csrc/`.  t is detached, as the JAX package stops
its gradient: geometry is not differentiated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..accel import traverse as _traverse
from ..accel.bvh import FlatBVH
from ..core import rng, vec
from ..scene.types import Scene

BIG = 1e30
_EPS_DIV = 1e-12
_TRI_EPS = 1e-7


class HitRecord(NamedTuple):
    """The structure-of-arrays hit record (reference `hit_record`,
    `hittable.h:8-23`)."""

    hit: torch.Tensor         # (N,) bool
    t: torch.Tensor           # (N,)
    p: torch.Tensor           # (N, 3)
    normal: torch.Tensor      # (N, 3) faced against the ray
    front_face: torch.Tensor  # (N,) bool
    u: torch.Tensor           # (N,)
    v: torch.Tensor           # (N,)
    mat_id: torch.Tensor      # (N,) int32


class Geometry(NamedTuple):
    """A scene's geometry tables as tensors on one device (ids as int64),
    made once by `geometry` and passed to every `closest_hit`."""

    spheres: object
    rects: object
    boxes: object
    triangles: object
    sphere_bvh: Optional[FlatBVH]
    tri_bvh: Optional[FlatBVH]
    has_sphere_media: bool
    has_box_media: bool


class MediaDraws(NamedTuple):
    """The uniforms of one `closest_hit`'s free paths: (N, S) for the
    sphere table's rows and (N, B) for the box table's, None where the
    scene has no such media (`_media_candidate` draws them from the two
    halves of its key)."""

    sphere: Optional[torch.Tensor]
    box: Optional[torch.Tensor]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    t = torch.as_tensor(a, device=device)
    return t.long() if a.dtype == np.int32 else t


def _table(tbl, device):
    return dataclasses.replace(tbl, **{
        f.name: _tensor(getattr(tbl, f.name), device)
        for f in dataclasses.fields(tbl)})


def geometry(scene: Scene, device: torch.device | str) -> Geometry:
    """The scene's sphere, rect, box and triangle tables and its BVHs on
    `device`."""
    def bvh(b):
        return None if b is None else FlatBVH(*(_tensor(a, device)
                                                for a in b))

    return Geometry(_table(scene.spheres, device), _table(scene.rects, device),
                    _table(scene.boxes, device),
                    _table(scene.triangles, device), bvh(scene.sphere_bvh),
                    bvh(scene.tri_bvh), bool(scene.has_sphere_media),
                    bool(scene.has_box_media))


def draw_media(generator: torch.Generator, geom: Geometry,
               n: int) -> MediaDraws:
    """Fresh media uniforms for n rays from `generator`: the sphere
    table's, then the box table's."""
    sp = (rng.uniform(generator, (n, geom.spheres.radius.shape[0]))
          if geom.has_sphere_media else None)
    bx = (rng.uniform(generator, (n, geom.boxes.mat_id.shape[0]))
          if geom.has_box_media else None)
    return MediaDraws(sp, bx)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    tiny = torch.where(den >= 0, _EPS_DIV, -_EPS_DIV)
    return num / torch.where(den.abs() < _EPS_DIV, tiny, den)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] per row: the last axis picked by an index of x's
    leading shape."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


# --------------------------------------------------------------------------
# spheres
# --------------------------------------------------------------------------


def _sphere_quadratic(sp, o, d, tm):
    """(near, far, has_roots), each (N, S): every ray against every sphere
    row, the center moved to the ray's time (reference `sphere.h:35-45`,
    `moving_sphere.h:20-22`)."""
    span = sp.time1 - sp.time0
    denom = torch.where(span.abs() < 1e-12, 1.0, span)
    frac = (tm[:, None] - sp.time0[None, :]) / denom[None, :]
    center = (sp.center0[None, :, :]
              + frac[..., None] * (sp.center1 - sp.center0)[None, :, :])
    oc = o[:, None, :] - center
    a = vec.dot(d, d)[:, None]
    half_b = vec.dot(oc, d[:, None, :])
    c = vec.dot(oc, oc) - (sp.radius * sp.radius)[None, :]
    disc = half_b * half_b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_a = 1.0 / torch.clamp(a, min=_EPS_DIV)
    return (-half_b - sq) * inv_a, (-half_b + sq) * inv_a, disc > 0.0


def _sphere_ts(sp, o, d, tm, t_min, t_max) -> torch.Tensor:
    """Closest valid t per (ray, sphere), BIG on a miss: the near root,
    else the far one (the intended RTOW semantics, SURVEY quirk 1)."""
    near, far, has = _sphere_quadratic(sp, o, d, tm)
    ok_near = has & (near >= t_min) & (near <= t_max)
    ok_far = has & (far >= t_min) & (far <= t_max)
    t = torch.where(ok_near, near, torch.where(ok_far, far, BIG))
    return torch.where((sp.active & ~sp.medium)[None, :], t, BIG)


def _sphere_record(sp, idx, o, d, tm, t):
    """The winning sphere's outward normal, uv and material (reference
    `sphere.h:19-32`, `:57-73`); `u_off` is a rotate_y instance's uv phase."""
    span = sp.time1[idx] - sp.time0[idx]
    denom = torch.where(span.abs() < 1e-12, 1.0, span)
    frac = (tm - sp.time0[idx]) / denom
    c0 = sp.center0[idx]
    center = c0 + frac[..., None] * (sp.center1[idx] - c0)
    p = o + t[..., None] * d
    radius = sp.radius[idx]
    outward = (p - center) / torch.where(radius.abs() < _EPS_DIV, 1.0,
                                         radius)[..., None]
    theta = torch.arccos(torch.clamp(-outward[..., 1], -1.0, 1.0))
    phi = torch.atan2(-outward[..., 2], outward[..., 0]) + math.pi
    u = torch.remainder(phi / (2.0 * math.pi) + sp.u_off[idx], 1.0)
    v = theta / math.pi
    return outward, u, v, sp.mat_id[idx]


# --------------------------------------------------------------------------
# axis-aligned rects
# --------------------------------------------------------------------------


def _rect_axes(axis: torch.Tensor):
    """The varying axes (a, b) of each rect's constant axis: yz -> (y, z),
    xz -> (x, z), xy -> (x, y) (reference `aarect.h:63-150`)."""
    return torch.where(axis == 0, 1, 0), torch.where(axis == 2, 1, 2)


def _rect_ts(rc, o, d, t_min, t_max) -> torch.Tensor:
    """Plane hit and range test per (ray, rect)."""
    a_ax, b_ax = _rect_axes(rc.axis)
    o_k, d_k = o[:, rc.axis], d[:, rc.axis]             # (N, R)
    t = _safe_div(rc.k[None, :] - o_k, d_k)
    pa = o[:, a_ax] + t * d[:, a_ax]
    pb = o[:, b_ax] + t * d[:, b_ax]
    ok = ((t >= t_min) & (t <= t_max)
          & (pa >= rc.a0[None]) & (pa <= rc.a1[None])
          & (pb >= rc.b0[None]) & (pb <= rc.b1[None]) & rc.active[None])
    return torch.where(ok, t, BIG)


def _rect_record(rc, idx, o, d, t):
    ax = rc.axis[idx]
    a_ax, b_ax = _rect_axes(ax)
    p = o + t[..., None] * d
    u = ((_take(p, a_ax) - rc.a0[idx])
         / torch.clamp(rc.a1[idx] - rc.a0[idx], min=_EPS_DIV))
    v = ((_take(p, b_ax) - rc.b0[idx])
         / torch.clamp(rc.b1[idx] - rc.b0[idx], min=_EPS_DIV))
    outward = torch.nn.functional.one_hot(ax, 3).to(p.dtype)
    return outward, u, v, rc.mat_id[idx]


# --------------------------------------------------------------------------
# boxes: one slab test under the rotate_y + translate instance
# --------------------------------------------------------------------------


def _to_object(c, s, offset, o, d):
    """World -> object ray: translate, then rotate_y (`translate::hit`,
    `rotate_y::hit`, `hittable.h:38,100-123`)."""
    ox = o[..., 0] - offset[..., 0]
    oy = o[..., 1] - offset[..., 1]
    oz = o[..., 2] - offset[..., 2]
    dx, dy, dz = (torch.broadcast_to(d[..., k], ox.shape) for k in range(3))
    o_obj = torch.stack((c * ox - s * oz, oy, s * ox + c * oz), dim=-1)
    d_obj = torch.stack((c * dx - s * dz, dy, s * dx + c * dz), dim=-1)
    return o_obj, d_obj


def _slab_inv(d_obj: torch.Tensor) -> torch.Tensor:
    tiny = torch.where(d_obj >= 0, _EPS_DIV, -_EPS_DIV)
    return 1.0 / torch.where(d_obj.abs() < _EPS_DIV, tiny, d_obj)


def _box_slabs(bx, o, d):
    """(t_near, t_far) per (ray, box) (reference `aabb.h:19-104` over a
    whole box)."""
    o_obj, d_obj = _to_object(bx.cos_t[None, :], bx.sin_t[None, :],
                              bx.offset[None, :, :], o[:, None, :],
                              d[:, None, :])
    inv = _slab_inv(d_obj)
    t0 = (bx.bmin[None, :, :] - o_obj) * inv
    t1 = (bx.bmax[None, :, :] - o_obj) * inv
    return (torch.minimum(t0, t1).amax(dim=-1),
            torch.maximum(t0, t1).amin(dim=-1))


def _box_ts(bx, o, d, t_min, t_max) -> torch.Tensor:
    """The entering face's t when it is past t_min, else the exit face's
    (the ray starts inside)."""
    tn, tf = _box_slabs(bx, o, d)
    t = torch.where(tn >= t_min, tn, tf)
    ok = ((tf > torch.clamp(tn, min=0.0)) & (t >= t_min) & (t <= t_max)
          & (bx.active & ~bx.medium)[None])
    return torch.where(ok, t, BIG)


def _box_record(bx, idx, o, d, t):
    """Face, normal and uv of the winning box, in object space: the face
    is the slab bound closest to t (the first of the six on a tie)."""
    c, s = bx.cos_t[idx], bx.sin_t[idx]
    o_obj, d_obj = _to_object(c, s, bx.offset[idx], o, d)
    inv = _slab_inv(d_obj)
    bmin, bmax = bx.bmin[idx], bx.bmax[idx]
    t_lo = (bmin - o_obj) * inv
    t_hi = (bmax - o_obj) * inv
    face = torch.argmin((torch.cat((t_lo, t_hi), dim=-1)
                         - t[..., None]).abs(), dim=-1)
    axis = face % 3
    sign = torch.where(face >= 3, 1.0, -1.0)
    n_obj = torch.nn.functional.one_hot(axis, 3).to(o.dtype) * sign[..., None]
    nx = c * n_obj[..., 0] + s * n_obj[..., 2]
    nz = -s * n_obj[..., 0] + c * n_obj[..., 2]
    outward = torch.stack((nx, n_obj[..., 1], nz), dim=-1)
    # uv on the hit face, as the reference's six rects (box.h:14-27)
    p_obj = o_obj + t[..., None] * d_obj
    a_ax, b_ax = _rect_axes(axis)
    ext = torch.clamp(bmax - bmin, min=_EPS_DIV)
    u = (_take(p_obj, a_ax) - _take(bmin, a_ax)) / _take(ext, a_ax)
    v = (_take(p_obj, b_ax) - _take(bmin, b_ax)) / _take(ext, b_ax)
    return outward, u, v, bx.mat_id[idx]


# --------------------------------------------------------------------------
# triangles (Moller-Trumbore)
# --------------------------------------------------------------------------


def _tri_ts(tr, o, d, t_min, t_max) -> torch.Tensor:
    """Every ray against every triangle (reference `triangle.h:120-160`)."""
    dd = d[:, None, :]
    e1, e2 = tr.e1[None, :, :], tr.e2[None, :, :]
    h = vec.cross(dd, e2)                               # (N, T, 3)
    a = vec.dot(e1, h)
    f = 1.0 / torch.where(a.abs() < _TRI_EPS, _TRI_EPS, a)
    s = o[:, None, :] - tr.v0[None, :, :]
    u = f * vec.dot(s, h)
    q = vec.cross(s, e1)
    v = f * vec.dot(dd, q)
    t = f * vec.dot(e2, q)
    ok = ((a.abs() > _TRI_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= max(t_min, _TRI_EPS)) & (t <= t_max)
          & tr.active[None])
    return torch.where(ok, t, BIG)


def tri_record(tr, idx, o, d, t):
    """The winning triangle's attributes by barycentric interpolation
    (reference `triangle.h:101-116`, `:160-174`)."""
    v0, e1, e2 = tr.v0[idx], tr.e1[idx], tr.e2[idx]
    p = o + t[..., None] * d
    v2p = p - v0
    d00, d01, d11 = vec.dot(e1, e1), vec.dot(e1, e2), vec.dot(e2, e2)
    d20, d21 = vec.dot(v2p, e1), vec.dot(v2p, e2)
    den = d00 * d11 - d01 * d01
    inv = 1.0 / torch.where(den.abs() < _EPS_DIV, _EPS_DIV, den)
    b0 = (d11 * d20 - d01 * d21) * inv   # the weight of vertex 1
    b1 = (d00 * d21 - d01 * d20) * inv   # of vertex 2
    b2 = 1.0 - b0 - b1                   # of vertex 0
    w0, w1, w2 = b2[..., None], b0[..., None], b1[..., None]
    uv = w0 * tr.uv0[idx] + w1 * tr.uv1[idx] + w2 * tr.uv2[idx]
    face_n = vec.cross(e2, e1)  # the reference's order, cross(v1, v0)
    vert_n = w0 * tr.n0[idx] + w1 * tr.n1[idx] + w2 * tr.n2[idx]
    outward = vec.where(tr.has_vn[idx], vert_n, face_n)
    return outward, uv[..., 0], uv[..., 1], tr.mat_id[idx]


# --------------------------------------------------------------------------
# constant media
# --------------------------------------------------------------------------


def _medium_sample(enter_raw, exit_raw, exists, neg_inv_density, d_len, u,
                   t_min, t_solid):
    """An exponential free path in each boundary's interval, clipped to
    [t_min, t_solid]: its t, or BIG where the ray passes through."""
    enter = torch.clamp(enter_raw, min=t_min)
    exit_ = torch.minimum(exit_raw, t_solid[:, None])
    seg = (exit_ - enter) * d_len
    valid_seg = exists & (exit_ > enter)
    hit_dist = neg_inv_density * torch.log(torch.clamp(u, min=1e-12))
    t = enter + hit_dist / d_len
    return torch.where(valid_seg & (hit_dist <= seg), t, BIG)


def _media_candidate(geom: Geometry, draws: MediaDraws, o, d, tm, t_min,
                     t_solid):
    """(t, mat_id, valid) of each ray's closest scattering event in a
    medium (reference `constant_medium::hit`, `constant_medium.h:34-70`):
    the argmin over the sphere media's columns, then the box media's, so
    the first column wins a tie."""
    sp, bx = geom.spheres, geom.boxes
    d_len = torch.sqrt(vec.dot(d, d))[:, None]
    ts_parts, mats_parts = [], []
    if geom.has_sphere_media:
        near, far, has = _sphere_quadratic(sp, o, d, tm)
        ts_parts.append(_medium_sample(
            near, far, has & (sp.medium & sp.active)[None],
            sp.neg_inv_density[None], d_len, draws.sphere, t_min, t_solid))
        mats_parts.append(sp.mat_id)
    if geom.has_box_media:
        tn, tf = _box_slabs(bx, o, d)
        ts_parts.append(_medium_sample(
            tn, tf, (tf > tn) & (bx.medium & bx.active)[None],
            bx.neg_inv_density[None], d_len, draws.box, t_min, t_solid))
        mats_parts.append(bx.mat_id)
    n = o.shape[0]
    if not ts_parts:
        return (torch.full((n,), BIG, device=o.device),
                torch.zeros(n, dtype=torch.int64, device=o.device),
                torch.zeros(n, dtype=torch.bool, device=o.device))
    t, best = _candidate(torch.cat(ts_parts, dim=1))
    return t, torch.cat(mats_parts)[best], t < BIG * 0.5


# --------------------------------------------------------------------------
# the closest hit
# --------------------------------------------------------------------------


def _candidate(ts: torch.Tensor):
    """(N, P) t-matrix -> each ray's least t and its first index."""
    idx = torch.argmin(ts, dim=1)
    return torch.gather(ts, 1, idx[:, None])[:, 0], idx


def closest_hit(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                tm: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[MediaDraws] = None, t_min: float = 0.001,
                t_max: float = BIG,
                geom: Optional[Geometry] = None) -> HitRecord:
    """The closest hit of every ray (`intersect.closest_hit`; the
    reference's `(*world)->hit`, `hittable_list.h:23-39`).

    o, d: (N, 3) float32; tm: (N,) shutter times.  The media's uniforms
    come from `generator`, or are given (`draws`); `geom` is
    `geometry(scene, o.device)`, made here when not given."""
    if geom is None:
        geom = geometry(scene, o.device)
    if draws is None and (geom.has_sphere_media or geom.has_box_media):
        draws = draw_media(generator, geom, o.shape[0])
    if geom.sphere_bvh is not None:
        t_s, i_s = _traverse.traverse_spheres(geom.spheres, geom.sphere_bvh,
                                              o, d, tm, t_min, t_max)
    else:
        t_s, i_s = _candidate(_sphere_ts(geom.spheres, o, d, tm, t_min,
                                         t_max))
    t_r, i_r = _candidate(_rect_ts(geom.rects, o, d, t_min, t_max))
    t_b, i_b = _candidate(_box_ts(geom.boxes, o, d, t_min, t_max))
    if geom.tri_bvh is not None:
        t_t, i_t = _traverse.traverse_triangles(geom.triangles, geom.tri_bvh,
                                                o, d, t_min, t_max)
    else:
        t_t, i_t = _candidate(_tri_ts(geom.triangles, o, d, t_min, t_max))

    t_solid, type_best = _candidate(torch.stack((t_s, t_r, t_b, t_t), dim=1))
    t_med, med_mat, med_valid = _media_candidate(geom, draws, o, d, tm,
                                                 t_min, t_solid)
    is_medium = med_valid & (t_med < t_solid)
    # geometry is not differentiated: hit points carry no tangents of t
    t_final = torch.where(is_medium, t_med, t_solid).detach()
    hit = t_final < BIG * 0.5

    # the winner's record of each type, then the winning type's
    n_s, u_s, v_s, m_s = _sphere_record(geom.spheres, i_s, o, d, tm, t_final)
    n_r, u_r, v_r, m_r = _rect_record(geom.rects, i_r, o, d, t_final)
    n_b, u_b, v_b, m_b = _box_record(geom.boxes, i_b, o, d, t_final)
    n_t, u_t, v_t, m_t = tri_record(geom.triangles, i_t, o, d, t_final)

    def sel(xs, xr, xb, xt):
        w = type_best if xs.dim() == 1 else type_best[:, None]
        out = torch.where(w == 1, xr, xs)
        out = torch.where(w == 2, xb, out)
        return torch.where(w == 3, xt, out)

    outward = sel(n_s, n_r, n_b, n_t)
    u, v = sel(u_s, u_r, u_b, u_t), sel(v_s, v_r, v_b, v_t)
    mat_id = sel(m_s, m_r, m_b, m_t)

    # set_face_normal (hittable.h:15-22)
    front = vec.dot(d, outward) < 0.0
    normal = vec.unit(vec.where(front, outward, -outward))
    # a medium's event: an arbitrary normal and front (constant_medium.h:63-64)
    med_n = torch.zeros_like(normal)
    med_n[:, 0] = 1.0
    normal = vec.where(is_medium, med_n, normal)
    front = front | is_medium
    u = torch.where(is_medium, 0.0, u)
    v = torch.where(is_medium, 0.0, v)
    mat_id = torch.where(is_medium, med_mat, mat_id).to(torch.int32)
    p = o + t_final[..., None] * d
    return HitRecord(hit=hit, t=t_final, p=p, normal=normal,
                     front_face=front, u=u, v=v, mat_id=mat_id)
