"""Path tracing of the dense Cornell scenes, lane by lane in plain torch.

One lane is one camera sample: the pixel it samples and its random
stream.  Every bounce tests the rects, then the boxes (a closest hit with
a strict `<`, reference `hittable_list.h`), then draws a free path in each
box medium (`constant_medium.h:34-70`), makes the face normal
(`hittable.h`), and scatters a lambertian (`material.h`, normal plus a
unit vector) or isotropic (a point in the unit ball) hit; a diffuse light
ends the path with its emission, a miss with the background
(`render.h:55-81`).  Paths carry a throughput; the arithmetic is the
port's, operation for operation, so that a float32 run and a sound
float32 run of the port round alike.  `dtype` runs the same in another
precision (the comparison's control).

Only the lanes still alive are carried from one bounce to the next, and
the lanes go through in blocks, so memory stays bounded.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import rng
from .scene import DIFFUSE_LIGHT, ISOTROPIC, KINDS, Camera, Scene, f32

BIG = f32(1e30)
EPS = f32(1e-12)
TWO_PI = f32(2.0 * math.pi)
DEGEN = f32(1e-8)
NORM_FLOOR = f32(1e-20)
THIRD = f32(1.0 / 3.0)
LEN_FLOOR = f32(1e-30)
HIT_BIT, CONT_BIT, MISS_BIT = 1 << 16, 1 << 17, 1 << 18
BLOCK = 1 << 21  # lanes traced together


def zero_counts() -> dict:
    """Work counts of traced paths: lanes, live bounces, continued
    bounces, and scattering hits by material kind."""
    return dict(paths=0, live=0, cont=0, scatter={k: 0 for k in KINDS})


class _Consts:
    """Scalars of one dtype on one device, for `torch.where`'s branches."""

    def __init__(self, dtype: torch.dtype, dev: torch.device):
        self.dtype, self.dev = dtype, dev
        self.one = torch.tensor(1.0, dtype=dtype, device=dev)
        self.zero = torch.tensor(0.0, dtype=dtype, device=dev)
        self.eps = torch.tensor(EPS, dtype=dtype, device=dev)


def _guard(v: torch.Tensor, c: _Consts) -> torch.Tensor:
    """|v| < 1e-12 becomes +-1e-12, keeping the sign."""
    return torch.where(v.abs() < EPS, torch.where(v >= 0, c.eps, -c.eps), v)


def camera_rays(cam: Camera, pix: torch.Tensor, base: torch.Tensor,
                c: _Consts) -> tuple:
    """Origins and directions (each three tensors) of the lanes' camera
    rays: the pixel (clamped to the image) jittered by two draws."""
    if cam.lens_radius != 0.0:
        raise NotImplementedError("a lens: the Cornell cameras have none")
    h, w = cam.height, cam.width
    pix = torch.clamp(pix, max=h * w - 1)
    row = torch.div(pix, w, rounding_mode="floor")
    col = pix - row * w
    row = torch.clamp(row, max=h - 1)
    cdraw = rng.camera_draw(base)
    su = (col.to(c.dtype) + rng.uniform(cdraw, 0, c.dtype)) * cam.inv_w
    sv = ((h - 1 - row).to(c.dtype) + rng.uniform(cdraw, 1, c.dtype)) \
        * cam.inv_h
    zeros = torch.zeros(pix.shape, dtype=c.dtype, device=c.dev)
    o3 = tuple(cam.origin[k] + zeros for k in range(3))
    d3 = tuple(cam.llc[k] + su * cam.hor[k] + sv * cam.ver[k] - o3[k]
               for k in range(3))
    return o3, d3


def _box_frame(prim: dict, o3: tuple, d3: tuple) -> tuple:
    """World to object space of a box under rotate_y and translate: the
    origin and the rotated direction's x and z."""
    ox, oy, oz = o3
    dx, _, dz = d3
    cs, sn = prim["cos"], prim["sin"]
    ox_t = ox - prim["off"][0]
    oy_t = oy - prim["off"][1]
    oz_t = oz - prim["off"][2]
    return ((cs * ox_t - sn * oz_t, oy_t, sn * ox_t + cs * oz_t),
            (cs * dx - sn * dz, sn * dx + cs * dz))


def _slabs(prim: dict, o_obj: tuple, dx2, dy, dz2, c: _Consts) -> tuple:
    """Near and far distances of the three slabs: (tnx, tfx, tny, tfy,
    tnz, tfz)."""
    lo, hi = prim["bmin"], prim["bmax"]
    ox2, oy_t, oz2 = o_obj
    ivx = 1.0 / _guard(dx2, c)
    ivy = 1.0 / _guard(dy, c)
    ivz = 1.0 / _guard(dz2, c)
    tx0, tx1 = (lo[0] - ox2) * ivx, (hi[0] - ox2) * ivx
    ty0, ty1 = (lo[1] - oy_t) * ivy, (hi[1] - oy_t) * ivy
    tz0, tz1 = (lo[2] - oz2) * ivz, (hi[2] - oz2) * ivz
    return (torch.minimum(tx0, tx1), torch.maximum(tx0, tx1),
            torch.minimum(ty0, ty1), torch.maximum(ty0, ty1),
            torch.minimum(tz0, tz1), torch.maximum(tz0, tz1))


def closest_hit(scene: Scene, o3: tuple, d3: tuple, draw: torch.Tensor,
                t_min: float, c: _Consts) -> tuple:
    """(t, outward normal, material) of each lane's nearest hit: BIG and
    material 0 on a miss.  A medium's scatter event beats the surface
    behind it, with the normal (1, 0, 0)."""
    dx, dy, dz = d3
    shape = dx.shape
    t_best = torch.full(shape, BIG, dtype=c.dtype, device=c.dev)
    n3 = [torch.zeros(shape, dtype=c.dtype, device=c.dev) for _ in range(3)]
    mat = torch.zeros(shape, dtype=torch.int64, device=c.dev)

    def take(ok, t, normal, m):
        nonlocal t_best, mat
        better = ok & (t < t_best)
        t_best = torch.where(better, t, t_best)
        for k in range(3):
            n3[k] = torch.where(better, normal[k], n3[k])
        mat = torch.where(better, m, mat)

    for r in scene.rects:
        ax = r["axis"]
        a_ax = 1 if ax == 0 else 0
        b_ax = 1 if ax == 2 else 2
        t = (r["k"] - o3[ax]) / _guard(d3[ax], c)
        pa = o3[a_ax] + t * d3[a_ax]
        pb = o3[b_ax] + t * d3[b_ax]
        ok = ((t >= t_min) & (pa >= r["a0"]) & (pa <= r["a1"])
              & (pb >= r["b0"]) & (pb <= r["b1"]))
        normal = [c.zero, c.zero, c.zero]
        normal[ax] = c.one
        take(ok, t, normal, r["mat"])

    for b in scene.boxes:
        o_obj, (dx2, dz2) = _box_frame(b, o3, d3)
        tnx, tfx, tny, tfy, tnz, tfz = _slabs(b, o_obj, dx2, dy, dz2, c)
        tn = torch.maximum(torch.maximum(tnx, tny), tnz)
        tf = torch.minimum(torch.minimum(tfx, tfy), tfz)
        inside = tf > torch.clamp(tn, min=0.0)
        t = torch.where(tn >= t_min, tn, tf)
        ok = inside & (t >= t_min)
        is_x = (t == tnx) | (t == tfx)
        is_y = (t == tny) | (t == tfy)
        exiting = t == tf
        sx = torch.where((dx2 >= 0) ^ exiting, -c.one, c.one)
        sy = torch.where((dy >= 0) ^ exiting, -c.one, c.one)
        sz = torch.where((dz2 >= 0) ^ exiting, -c.one, c.one)
        nx = torch.where(is_x, sx, c.zero)
        ny = torch.where(~is_x & is_y, sy, c.zero)
        nz = torch.where(~is_x & ~is_y, sz, c.zero)
        cs, sn = b["cos"], b["sin"]
        take(ok, t, (cs * nx + sn * nz, ny, (-sn) * nx + cs * nz), b["mat"])

    if scene.media:
        d_len = torch.sqrt(dx * dx + dy * dy + dz * dz)
        inv_dlen = 1.0 / torch.clamp(d_len, min=LEN_FLOOR)
        m_t = torch.full(shape, BIG, dtype=c.dtype, device=c.dev)
        m_mat = torch.zeros(shape, dtype=torch.int64, device=c.dev)
        for im, m in enumerate(scene.media):
            o_obj, (dx2, dz2) = _box_frame(m, o3, d3)
            tnx, tfx, tny, tfy, tnz, tfz = _slabs(m, o_obj, dx2, dy, dz2, c)
            lo = torch.maximum(torch.maximum(tnx, tny), tnz)
            hi = torch.minimum(torch.minimum(tfx, tfy), tfz)
            exists = hi > lo
            enter = torch.clamp(lo, min=t_min)
            exit_ = torch.minimum(hi, t_best)
            seg = (exit_ - enter) * d_len
            u_fp = torch.clamp(rng.uniform(draw, 16 + im, c.dtype), min=EPS)
            dist = m["nid"] * torch.log(u_fp)
            t_m = enter + dist * inv_dlen
            ok = exists & (exit_ > enter) & (dist <= seg)
            better = ok & (t_m < m_t)
            m_t = torch.where(better, t_m, m_t)
            m_mat = torch.where(better, m["mat"], m_mat)
        win = m_t < t_best
        t_best = torch.where(win, m_t, t_best)
        n3 = [torch.where(win, c.one, n3[0]), torch.where(win, c.zero, n3[1]),
              torch.where(win, c.zero, n3[2])]
        mat = torch.where(win, m_mat, mat)
    return t_best, tuple(n3), mat


def _unit_vector(draw: torch.Tensor, salt: int, c: _Consts) -> tuple:
    z = 2.0 * rng.uniform(draw, salt, c.dtype) - 1.0
    phi = TWO_PI * rng.uniform(draw, salt + 1, c.dtype)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return r * torch.cos(phi), r * torch.sin(phi), z


def _in_sphere(draw: torch.Tensor, salt: int, c: _Consts) -> tuple:
    ux, uy, uz = _unit_vector(draw, salt, c)
    u = torch.clamp(rng.uniform(draw, salt + 2, c.dtype), min=EPS)
    r = torch.exp(torch.log(u) * THIRD)
    return r * ux, r * uy, r * uz


def _scatter(is_iso, draw: torch.Tensor, n3: tuple, c: _Consts) -> tuple:
    """The next direction: the unit normal plus a unit vector (the normal
    itself where that sum is degenerate); an isotropic hit's a point in
    the unit ball."""
    nx, ny, nz = n3
    ux, uy, uz = _unit_vector(draw, 0, c)
    lx, ly, lz = nx + ux, ny + uy, nz + uz
    degen = (lx.abs() < DEGEN) & (ly.abs() < DEGEN) & (lz.abs() < DEGEN)
    out = (torch.where(degen, nx, lx), torch.where(degen, ny, ly),
           torch.where(degen, nz, lz))
    if is_iso is None:
        return out
    s3 = _in_sphere(draw, 3, c)
    return tuple(torch.where(is_iso, s, o) for s, o in zip(s3, out))


def trace(scene: Scene, cam: Camera, pix: torch.Tensor, base: torch.Tensor,
          depth: int, t_min: float, record: bool = False,
          dtype: torch.dtype = torch.float32, albedo=None,
          counts: Optional[dict] = None) -> torch.Tensor:
    """Trace one camera sample a lane: `pix` the pixel, `base` the lane's
    stream (`rng.lane_base`).

    Returns the radiance, (n, 3) in `dtype`; with `record`, the record
    planes instead: (depth, n) int32 words `material | hit << 16 | cont <<
    17 | miss << 18` a bounce, 0 once the path has ended.  `albedo`
    ((M, 3), default the scene's) colours the paths; the walk does not
    depend on it.  `counts` (`zero_counts`) receives the paths' work."""
    dev = pix.device
    c = _Consts(dtype, dev)
    n = pix.numel()
    alb = torch.as_tensor(scene.albedo if albedo is None else albedo,
                          device=dev).to(dtype)
    kind_of = torch.tensor([KINDS.index(k) for k in scene.kinds],
                           dtype=torch.int64, device=dev)
    light_k, iso_k = KINDS.index(DIFFUSE_LIGHT), KINDS.index(ISOTROPIC)
    has_iso = ISOTROPIC in scene.kinds
    bg = scene.background
    if record:
        out = torch.zeros((depth, n), dtype=torch.int32, device=dev)
    else:
        out = torch.zeros((n, 3), dtype=dtype, device=dev)
    t_min = f32(t_min)
    for lo in range(0, n, BLOCK):
        idx = torch.arange(lo, min(n, lo + BLOCK), device=dev)
        lane_b = base[idx]
        o3, d3 = camera_rays(cam, pix[idx], lane_b, c)
        tr = [torch.ones(idx.shape, dtype=dtype, device=dev)
              for _ in range(3)]
        if counts is not None:
            counts["paths"] += idx.numel()
        for b in range(depth):
            if idx.numel() == 0:
                break
            draw = rng.bounce_draw(lane_b, b)
            t, n_out, mat = closest_hit(scene, o3, d3, draw, t_min, c)
            hit = t < BIG * 0.5
            miss = ~hit
            kind = kind_of[mat]
            light = hit & (kind == light_k)
            cont = hit & ~light
            dx, dy, dz = d3
            nx, ny, nz = n_out
            front = (dx * nx + dy * ny + dz * nz) < 0.0
            flip = torch.where(front, c.one, -c.one)
            nlen = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                                min=NORM_FLOOR))
            n3 = (nx * flip * nlen, ny * flip * nlen, nz * flip * nlen)
            p3 = tuple(o + t * d for o, d in zip(o3, d3))
            iso = (kind == iso_k) if has_iso else None
            new_d = _scatter(iso, draw, n3, c)
            if record:
                out[b, idx] = (mat.to(torch.int32)
                               | (hit.to(torch.int32) << 16)
                               | (cont.to(torch.int32) << 17)
                               | (miss.to(torch.int32) << 18))
            else:
                a = alb[mat]
                term = [torch.where(miss, tr[k] * bg[k],
                                    torch.where(light, tr[k] * a[:, k],
                                                c.zero))
                        for k in range(3)]
                ended = ~cont
                out[idx[ended]] = torch.stack(term, dim=1)[ended]
                tr = [torch.where(cont, tr[k] * a[:, k], tr[k])
                      for k in range(3)]
            if counts is not None:
                counts["live"] += idx.numel()
                counts["cont"] += int(cont.sum())
                for ki, k in enumerate(KINDS):
                    if k != DIFFUSE_LIGHT:
                        counts["scatter"][k] += int((hit & (kind == ki)).sum())
            idx, lane_b = idx[cont], lane_b[cont]
            o3 = tuple(p[cont] for p in p3)
            d3 = tuple(v[cont] for v in new_d)
            tr = [x[cont] for x in tr]
    return out
