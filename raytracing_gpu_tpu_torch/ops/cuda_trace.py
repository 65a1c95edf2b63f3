"""Host side of the path-tracing megakernel, and its plain PyTorch versions.

Counterpart of `raytracing_gpu_tpu/ops/pallas_trace.py` with the camera rays
made inside the kernel, in its two modes: forward radiance
(`PallasTracer.trace_pixels`) and the record walk
(`PallasTracer.walk_packed_pixels`), for the feature set the port covers so
far: axis-aligned rects, boxes under rotate_y + translate, lambertian and
diffuse_light materials, solid textures.  The kernels are
`csrc/megakernel.cu`; `trace_pixels_reference` and
`walk_packed_pixels_reference` are the same functions in plain PyTorch,
written op for op in the kernels' order so that the two round alike.

The random numbers are the JAX kernel's, bit for bit: a PCG hash of the
lane index within the call mixed with an int32 seed, then one more hash per
draw site (`pcg_hash`, `uniform`).  The plain versions do their uint32
arithmetic in int64 and mask after every multiply and add, because torch's
uint32 dtype lacks those operations on the CPU.

`Tracer` holds a baked scene on one device.  On a CUDA device its
`trace_pixels` and `walk_packed_pixels` launch the kernels (a failed build
or launch raises); on the CPU they run the plain versions.
`Tracer.launches` and `Tracer.record_launches` count the launches of each
kernel, so a caller can show that a render went through it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..scene import types as st
from ..scene.textures import TEXTURE_NAMES
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

# kernel record layouts (csrc/megakernel.cu reads these columns)
RECT_COLS = 12   # axis a0 a1 b0 b1 k kind c1r c1g c1b mat pad
BOX_COLS = 16    # bmin xyz, bmax xyz, cos sin, off xyz, kind, c1 rgb, mat
HIT_BIT, CONT_BIT, MISS_BIT = 1 << 16, 1 << 17, 1 << 18  # packed record word
_SUPPORTED_MATERIALS = {st.LAMBERTIAN, st.DIFFUSE_LIGHT}
_MATERIAL_NAMES = {st.METAL: "metal", st.DIELECTRIC: "dielectric",
                   st.ISOTROPIC: "isotropic"}


# --------------------------------------------------------------------------
# scene bake
# --------------------------------------------------------------------------


class SceneBake(NamedTuple):
    """Host snapshot of what the kernel reads: one dict of Python floats per
    active rect and box, with the same keys as the JAX bake's records, and
    the background."""

    rects: list
    boxes: list
    background: tuple

    def rect_table(self) -> np.ndarray:
        """(R, RECT_COLS) float32 records for the kernel."""
        t = np.zeros((len(self.rects), RECT_COLS), np.float32)
        for i, r in enumerate(self.rects):
            t[i, :11] = (r["axis"], r["a0"], r["a1"], r["b0"], r["b1"],
                         r["k"], r["kind"], *r["c1"], r["mat"])
        return t

    def box_table(self) -> np.ndarray:
        """(B, BOX_COLS) float32 records for the kernel."""
        t = np.zeros((len(self.boxes), BOX_COLS), np.float32)
        for i, b in enumerate(self.boxes):
            t[i, :16] = (*b["bmin"], *b["bmax"], b["cos"], b["sin"],
                         *b["off"], b["kind"], *b["c1"], b["mat"])
        return t


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
    """Snapshot the active rects and boxes, as `pallas_trace.bake_scene`
    (`:253-288`) does for them."""
    rc = scene.rects
    rects = [dict(axis=int(rc.axis[i]), a0=float(rc.a0[i]),
                  a1=float(rc.a1[i]), b0=float(rc.b0[i]), b1=float(rc.b1[i]),
                  k=float(rc.k[i]), **_mat_shading(scene, int(rc.mat_id[i])))
             for i in range(len(rc.axis)) if rc.active[i]]
    bx = scene.boxes
    boxes = [dict(bmin=tuple(float(x) for x in bx.bmin[i]),
                  bmax=tuple(float(x) for x in bx.bmax[i]),
                  cos=float(bx.cos_t[i]), sin=float(bx.sin_t[i]),
                  off=tuple(float(x) for x in bx.offset[i]),
                  **_mat_shading(scene, int(bx.mat_id[i])))
             for i in range(len(bx.cos_t)) if bx.active[i] and not bx.medium[i]]
    return SceneBake(rects=rects, boxes=boxes,
                     background=tuple(float(x) for x in scene.background))


def unported_feature(scene: st.Scene) -> Optional[str]:
    """The first feature of `scene` that the port's kernel does not cover,
    or None when it renders here."""
    if scene.spheres.active.any():
        return "spheres"
    if scene.triangles.active.any():
        return "triangles"
    if (scene.boxes.medium & scene.boxes.active).any():
        return "constant media"
    used = np.concatenate([scene.rects.mat_id[scene.rects.active],
                           scene.boxes.mat_id[scene.boxes.active]])
    for m in used:
        kind = int(scene.materials.kind[m])
        if kind not in _SUPPORTED_MATERIALS:
            return f"{_MATERIAL_NAMES.get(kind, kind)} material"
    for m in used:
        tk = int(scene.textures.kind[scene.materials.tex_id[m]])
        if tk != st.TEX_SOLID:
            return f"{TEXTURE_NAMES.get(tk, tk)} texture"
    return None


def supports_forward(scene: st.Scene) -> bool:
    """True when the kernel renders `scene`; otherwise `unported_feature`
    names what is missing."""
    return unported_feature(scene) is None


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
    directions, each a tuple of three (n,) float32 tensors."""
    f32 = torch.float32
    (corg, cllc, chor, cver, cuv, cvv, clr, _t0, _t1,
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
    # The shutter time is not made: nothing in the ported feature set (no
    # moving spheres, no media) reads it.
    ox = corg[0] + offx
    oy = corg[1] + offy
    oz = corg[2] + offz
    dx = cllc[0] + su * chor[0] + sv * cver[0] - ox
    dy = cllc[1] + su * chor[1] + sv * cver[1] - oy
    dz = cllc[2] + su * chor[2] + sv * cver[2] - oz
    return (ox, oy, oz), (dx, dy, dz)


class _Hit(NamedTuple):
    t: torch.Tensor       # (n,) BIG where nothing was hit
    normal: tuple         # outward normal, three (n,) tensors
    kind: torch.Tensor    # (n,) int32 material kind
    albedo: tuple         # solid albedo, three (n,) tensors
    mat: torch.Tensor     # (n,) int32 material id


def _closest_hit(bake: SceneBake, o3: tuple, d3: tuple, t_min: float,
                 n: int, dev: torch.device) -> _Hit:
    """Closest hit over the baked rects, then boxes, strict `<`
    (pallas_trace.py:961-1043)."""
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    t_best = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    nx, ny, nz = zeros, zeros, zeros
    kind = torch.zeros(n, dtype=torch.int32, device=dev)
    mat = torch.zeros(n, dtype=torch.int32, device=dev)
    ar, ag, ab = zeros, zeros, zeros

    def upd(ok, t, nxx, nyy, nzz, prim):
        better = ok & (t < t_best)
        c1 = prim["c1"]
        return (torch.where(better, t, t_best),
                torch.where(better, nxx, nx), torch.where(better, nyy, ny),
                torch.where(better, nzz, nz),
                torch.where(better, prim["kind"], kind),
                torch.where(better, c1[0], ar),
                torch.where(better, c1[1], ag),
                torch.where(better, c1[2], ab),
                torch.where(better, prim["mat"], mat))

    ox, oy, oz = o3
    dx, dy, dz = d3
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
        t_best, nx, ny, nz, kind, ar, ag, ab, mat = upd(ok, t, *n3, prim)

    for prim in bake.boxes:
        c, s = prim["cos"], prim["sin"]
        offx_b, offy_b, offz_b = prim["off"]
        ox_t = ox - offx_b
        oy_t = oy - offy_b
        oz_t = oz - offz_b
        ox2 = c * ox_t - s * oz_t
        oz2 = s * ox_t + c * oz_t
        dx2 = c * dx - s * dz
        dz2 = s * dx + c * dz
        lo, hi = prim["bmin"], prim["bmax"]
        ivx, ivy, ivz = 1.0 / _guard(dx2), 1.0 / _guard(dy), 1.0 / _guard(dz2)
        tx0 = (lo[0] - ox2) * ivx
        tx1 = (hi[0] - ox2) * ivx
        ty0 = (lo[1] - oy_t) * ivy
        ty1 = (hi[1] - oy_t) * ivy
        tz0 = (lo[2] - oz2) * ivz
        tz1 = (hi[2] - oz2) * ivz
        tnx, tfx = torch.minimum(tx0, tx1), torch.maximum(tx0, tx1)
        tny, tfy = torch.minimum(ty0, ty1), torch.maximum(ty0, ty1)
        tnz, tfz = torch.minimum(tz0, tz1), torch.maximum(tz0, tz1)
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
        nwx = c * nobj_x + s * nobj_z
        nwz = (-s) * nobj_x + c * nobj_z
        t_best, nx, ny, nz, kind, ar, ag, ab, mat = upd(ok, t, nwx, nobj_y,
                                                        nwz, prim)
    return _Hit(t_best, (nx, ny, nz), kind, (ar, ag, ab), mat)


def _lambertian_bounce(base: torch.Tensor, b: int, hit: torch.Tensor,
                       h: _Hit, o3: tuple, d3: tuple):
    """The next ray (origins, directions) of the lanes in `hit`, the others
    unchanged: set_face_normal + normalize (:1413-1419), the lambertian
    scatter n + unit_vector (:1445-1456), the origin moved to the hit point
    (:1549-1554)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    nx, ny, nz = h.normal
    front = (dx * nx + dy * ny + dz * nz) < 0.0
    flip = torch.where(front, 1.0, -1.0)
    nlen = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                        min=_NORM_FLOOR))
    nx = nx * flip * nlen
    ny = ny * flip * nlen
    nz = nz * flip * nlen
    px = ox + h.t * dx
    py = oy + h.t * dy
    pz = oz + h.t * dz

    draw = (base + (((b * 32) * _DRAW_MUL) & _M32)) & _M32
    z = 2.0 * uniform(draw, 0) - 1.0
    phi = _TWO_PI * uniform(draw, 1)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    ldx = nx + r * torch.cos(phi)
    ldy = ny + r * torch.sin(phi)
    ldz = nz + z
    degen = ((ldx.abs() < _DEGEN) & (ldy.abs() < _DEGEN)
             & (ldz.abs() < _DEGEN))
    ldx = torch.where(degen, nx, ldx)
    ldy = torch.where(degen, ny, ldy)
    ldz = torch.where(degen, nz, ldz)
    return ((torch.where(hit, px, ox), torch.where(hit, py, oy),
             torch.where(hit, pz, oz)),
            (torch.where(hit, ldx, dx), torch.where(hit, ldy, dy),
             torch.where(hit, ldz, dz)))


def trace_pixels_reference(bake: SceneBake, camera, img_h: int, img_w: int,
                           pix_base: int, n: int, seed: int,
                           max_depth: int = 50, t_min: float = 0.001,
                           device: torch.device | str = "cpu"
                           ) -> torch.Tensor:
    """Forward radiance (n, 3) float32 for pixels [pix_base, pix_base + n)
    of an img_h x img_w image, camera rays made from the PCG stream.

    The plain PyTorch version of `megakernel_fwd`, vectorized over the
    lanes of the call: every lane runs every bounce under an `alive` mask,
    and a dead lane adds nothing, so it matches a kernel thread that stops
    when its ray dies (pallas_trace.py:1397-1398, 1626-1637).
    """
    dev = torch.device(device)
    t_min = _f32(t_min)
    base = rng_base(n, seed, dev)
    o3, d3 = _camera_rays(camera, img_h, img_w, pix_base, n, base, dev)

    tr = torch.ones(n, dtype=torch.float32, device=dev)
    tg, tb = tr.clone(), tr.clone()
    lr, lg, lb = (torch.zeros(n, dtype=torch.float32, device=dev)
                  for _ in range(3))
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    bgr, bgg, bgb = bake.background

    for b in range(max_depth):
        if not bool(alive.any()):
            break
        h = _closest_hit(bake, o3, d3, t_min, n, dev)
        hit = alive & (h.t < BIG * 0.5)
        miss = alive & ~(h.t < BIG * 0.5)
        ar, ag, ab = h.albedo

        # ---- background on miss, emission on a light (:1432-1442) ----
        lr = lr + torch.where(miss, tr * bgr, 0.0)
        lg = lg + torch.where(miss, tg * bgg, 0.0)
        lb = lb + torch.where(miss, tb * bgb, 0.0)
        is_light = h.kind == st.DIFFUSE_LIGHT
        lit = hit & is_light
        lr = lr + torch.where(lit, tr * ar, 0.0)
        lg = lg + torch.where(lit, tg * ag, 0.0)
        lb = lb + torch.where(lit, tb * ab, 0.0)

        # ---- throughput and the next ray (:1512-1519, 1549-1554) ----
        cont = hit & ~is_light
        tr = torch.where(cont, tr * ar, tr)
        tg = torch.where(cont, tg * ag, tg)
        tb = torch.where(cont, tb * ab, tb)
        o3, d3 = _lambertian_bounce(base, b, hit, h, o3, d3)
        alive = cont

    return torch.stack((lr, lg, lb), dim=-1)


def walk_packed_pixels_reference(bake: SceneBake, camera, img_h: int,
                                 img_w: int, pix_base: int, n: int,
                                 seed: int, max_depth: int = 50,
                                 t_min: float = 0.001,
                                 device: torch.device | str = "cpu"
                                 ) -> torch.Tensor:
    """Record planes (max_depth, n) int32 for pixels [pix_base, pix_base + n):
    per bounce the packed word `mat | hit<<16 | cont<<17 | miss<<18`
    (pallas_trace.py:1536-1541), the same paths as `trace_pixels_reference`.

    The plain PyTorch version of `megakernel_record`.  A lane whose path
    has ended records 0, as a kernel thread does; the Pallas kernel stores the stale `mat` of a dead lane's frozen ray there
    (with every mask bit 0), so compare against it bits 16-18 everywhere
    and bits 0-15 only where bit 16 is set.
    """
    dev = torch.device(device)
    t_min = _f32(t_min)
    base = rng_base(n, seed, dev)
    o3, d3 = _camera_rays(camera, img_h, img_w, pix_base, n, base, dev)
    out = torch.zeros((max_depth, n), dtype=torch.int32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)

    for b in range(max_depth):
        if not bool(alive.any()):
            break
        h = _closest_hit(bake, o3, d3, t_min, n, dev)
        # hit, cont and miss as at pallas_trace.py:1397-1398, :1512-1513
        hit = alive & (h.t < BIG * 0.5)
        miss = alive & ~(h.t < BIG * 0.5)
        cont = hit & (h.kind != st.DIFFUSE_LIGHT)
        packed = (h.mat | (hit.to(torch.int32) << 16)
                  | (cont.to(torch.int32) << 17)
                  | (miss.to(torch.int32) << 18))
        out[b] = torch.where(alive, packed, 0)
        o3, d3 = _lambertian_bounce(base, b, hit, h, o3, d3)
        alive = cont

    return out


def record_agreement(got, want) -> dict:
    """How two stacks of record planes (..., max_depth, n) agree under the
    bit rule: bits 16-18 compared everywhere, bits 0-15 only where `want`
    has bit 16 set (a dead lane's mat bits carry nothing).

    Returns the fractions of entries whose masks agree (`mask_frac`), of
    hit entries whose mat agrees (`hit_mat_frac`), of lanes whose whole
    record agrees (`lane_frac`), of words equal bit for bit (`exact_frac`),
    and whether every lane agrees at bounce 0 (`first_bounce`) and
    everywhere (`bit_rule`).
    """
    def as_i64(x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().to(torch.int64)
        return torch.from_numpy(np.array(x, dtype=np.int64))

    got, want = as_i64(got), as_i64(want)
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} and "
                         f"{tuple(want.shape)}")
    mask = HIT_BIT | CONT_BIT | MISS_BIT
    masks = (got & mask) == (want & mask)
    hit = (want & HIT_BIT) != 0
    mats = (got & 0xFFFF) == (want & 0xFFFF)
    agree = masks & (mats | ~hit)
    return dict(mask_frac=float(masks.double().mean()),
                hit_mat_frac=float(mats[hit].double().mean()) if hit.any()
                else 1.0,
                lane_frac=float(agree.all(-2).double().mean()),
                exact_frac=float((got == want).double().mean()),
                first_bounce=bool(agree[..., 0, :].all()),
                bit_rule=bool(agree.all()))


# --------------------------------------------------------------------------
# the kernel wrapper
# --------------------------------------------------------------------------


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


def _check_table(t: torch.Tensor, cols: int, device: torch.device) -> None:
    if (t.device != device or t.dtype != torch.float32
            or not t.is_contiguous() or t.dim() != 2 or t.shape[1] != cols):
        raise ValueError(f"kernel table must be a contiguous float32 "
                         f"(rows, {cols}) tensor on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


class Tracer:
    """Scene-specialized tracer on one device, in forward and record mode.

    On a CUDA device `trace_pixels` and `walk_packed_pixels` launch
    `csrc/megakernel.cu`; on the CPU they run `trace_pixels_reference` and
    `walk_packed_pixels_reference`.  Nothing falls back from one to the
    other.
    """

    launches = 0         # megakernel_fwd launches in this process, all tracers
    record_launches = 0  # megakernel_record launches, likewise

    def __init__(self, scene: st.Scene, device: torch.device | str):
        feature = unported_feature(scene)
        if feature is not None:
            raise NotImplementedError(f"{feature}: not yet ported")
        self.device = torch.device(device)
        if self.device.type != "cpu":
            _require_cuda(self.device)
        self.bake = bake_scene(scene)
        self.rect_table = torch.as_tensor(self.bake.rect_table(),
                                          device=self.device)
        self.box_table = torch.as_tensor(self.bake.box_table(),
                                         device=self.device)

    def trace_pixels(self, camera, img_h: int, img_w: int, pix_base: int,
                     n: int, seed: int, max_depth: int = 50,
                     t_min: float = 0.001) -> torch.Tensor:
        """Forward radiance (n, 3) float32 on the tracer's device for
        pixels [pix_base, pix_base + n), with the camera rays made from the
        kernel's PCG stream (contract of `PallasTracer.trace_pixels`).
        Pixel ids past the image clamp to its last pixel; `seed` is an
        int32 (`wave_seed`)."""
        return self.bind(camera, img_h, img_w, max_depth, t_min)(pix_base, n,
                                                                  seed)

    def walk_packed_pixels(self, camera, img_h: int, img_w: int,
                           pix_base: int, n: int, seed: int,
                           max_depth: int = 50,
                           t_min: float = 0.001) -> torch.Tensor:
        """Record planes (max_depth, n) int32 on the tracer's device for
        pixels [pix_base, pix_base + n): per bounce the packed word
        `mat | hit<<16 | cont<<17 | miss<<18` (contract of
        `PallasTracer.walk_packed_pixels` for a scene whose textures are all
        solid, cropped to n lanes).  A bounce after the path's end is 0."""
        return self.bind_record(camera, img_h, img_w, max_depth, t_min)(
            pix_base, n, seed)

    def bind(self, camera, img_h: int, img_w: int, max_depth: int = 50,
             t_min: float = 0.001) -> Callable[[int, int, int], torch.Tensor]:
        """`trace_pixels` with the camera, image size, depth and t_min fixed:
        returns `launch(pix_base, n, seed) -> (n, 3)`.  The tables are
        checked and the launch constants computed here, once, so a render's
        host work per wave is the output allocation and the launch."""
        if self.device.type == "cpu":
            def plain(pix_base: int, n: int, seed: int) -> torch.Tensor:
                _check_count(n)
                return trace_pixels_reference(self.bake, camera, img_h, img_w,
                                              pix_base, n, seed, max_depth,
                                              t_min, self.device)
            return plain

        rects, boxes, device = self.rect_table, self.box_table, self.device
        p, check_range = self._launch_params(camera, img_h, img_w, max_depth,
                                             t_min)
        lib = build.load()

        def launch(pix_base: int, n: int, seed: int) -> torch.Tensor:
            check_range(pix_base, n)
            out = torch.empty((3, n), dtype=torch.float32, device=device)
            p.pix_base, p.n, p.seed = int(pix_base), int(n), _int32(seed)
            r = out.data_ptr()
            with torch.cuda.device(device):
                rc = lib.rt_trace_pixels(rects.data_ptr(), boxes.data_ptr(), p,
                                         r, r + 4 * n, r + 8 * n,
                                         _stream(device))
            _check(lib, rc, "rt_trace_pixels")
            Tracer.launches += 1
            return out.T

        return launch

    def bind_record(self, camera, img_h: int, img_w: int,
                    max_depth: int = 50, t_min: float = 0.001
                    ) -> Callable[[int, int, int], torch.Tensor]:
        """`walk_packed_pixels` with the camera, image size, depth and t_min
        fixed: returns `launch(pix_base, n, seed) -> (max_depth, n)` int32,
        with the launch constants computed once, as `bind` does."""
        if self.device.type == "cpu":
            def plain(pix_base: int, n: int, seed: int) -> torch.Tensor:
                _check_count(n)
                return walk_packed_pixels_reference(
                    self.bake, camera, img_h, img_w, pix_base, n, seed,
                    max_depth, t_min, self.device)
            return plain

        rects, boxes, device = self.rect_table, self.box_table, self.device
        p, check_range = self._launch_params(camera, img_h, img_w, max_depth,
                                             t_min)
        lib = build.load()

        def launch(pix_base: int, n: int, seed: int) -> torch.Tensor:
            check_range(pix_base, n)
            out = torch.empty((max_depth, n), dtype=torch.int32, device=device)
            p.pix_base, p.n, p.seed = int(pix_base), int(n), _int32(seed)
            with torch.cuda.device(device):
                rc = lib.rt_walk_packed_pixels(rects.data_ptr(),
                                               boxes.data_ptr(), p,
                                               out.data_ptr(), _stream(device))
            _check(lib, rc, "rt_walk_packed_pixels")
            Tracer.record_launches += 1
            return out

        return launch

    def _launch_params(self, camera, img_h: int, img_w: int, max_depth: int,
                       t_min: float):
        """The kernels' parameter block for a bound camera and image, with
        the per-launch fields left to fill, and the check of a launch's
        pixel range."""
        _check_table(self.rect_table, RECT_COLS, self.device)
        _check_table(self.box_table, BOX_COLS, self.device)
        (corg, cllc, chor, cver, cuv, cvv, clr, _t0, _t1,
         img_h, img_w) = _cam_tuple(camera, img_h, img_w)
        if img_h <= 0 or img_w <= 0 or max_depth < 0:
            raise ValueError(f"bad image {img_h}x{img_w} or depth {max_depth}")
        c3 = ctypes.c_float * 3
        p = build.RtParams(
            origin=c3(*corg), llc=c3(*cllc), hor=c3(*chor), ver=c3(*cver),
            cu=c3(*cuv), cv=c3(*cvv), lens_radius=clr,
            inv_w=_inv_extent(img_w), inv_h=_inv_extent(img_h),
            t_min=_f32(t_min), bg=c3(*self.bake.background),
            img_h=img_h, img_w=img_w, max_depth=int(max_depth),
            n_rects=self.rect_table.shape[0], n_boxes=self.box_table.shape[0])

        def check_range(pix_base: int, n: int) -> None:
            _check_count(n)
            # the kernels compute pixel ids and img_h * img_w in int32
            if pix_base < 0 or max(pix_base + n, img_h * img_w) > 2**31 - 1:
                raise ValueError(f"pixel range [{pix_base}, {pix_base + n}) "
                                 f"of a {img_h}x{img_w} image does not fit "
                                 "int32")

        return p, check_range
