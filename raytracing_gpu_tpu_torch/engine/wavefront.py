"""The wavefront renderers, and the glue around the hit kernel.

Counterpart of `raytracing_gpu_tpu/engine/wavefront.py`: `_part1by2`,
`_sort_keys`, `pack_attr_table`, `resolve_hit_packed`, `make_trace_wave`,
`compile_wavefront_renderer` and `compile_regen_renderer` (`:57-277`,
`:400-684`).  The bounce loop lives in torch around one closest-hit kernel
launch per bounce or step (`ops.cuda_trace.Tracer.hit`), whose triangle
winners resolve here by one gather of the slot-attribute table.

The regenerative renderer keeps a persistent, always-full wave of
`ray_batch` lanes in which a ray that ends deposits its radiance and its
lane is refilled with a fresh camera ray from a pixel-major sample stream
(ray s goes to pixel s // spp).  Each step:

1. sorts the lanes by (terminated, direction octant, origin morton), so the
   dead lanes move to the tail and the live ones into coherent packets;
2. refills the dead tail with consecutive stream rays;
3. takes one closest hit per lane and the torch half of the bounce: the
   attribute resolve, `materials.scatter`, emission, background, throughput
   and russian roulette;
4. adds the radiance of the rays that ended into a small power-of-two ring
   of pixel rows (the stream advances at most ray_batch / spp pixels a
   step and a ray lives at most max_depth steps, so (max_depth + 4) such
   windows never collide);
5. copies ring blocks that no live ray can reach any more into the
   framebuffer, at most two a step; a final flush adds what is left.

The bounce-synchronous renderer (`make_trace_wave`) traces one wave of
camera rays to the end: bounce 0 in pixel order, then each bounce sorted by
the same keys with one packed gather of the lanes' state, and one scatter
back to pixel order at the end.  Its record twin (`make_record_trace_wave`)
walks the same way without shading and writes each bounce's record row
back to pixel order: the detached walk of the differentiable
"wavefront-record" route (`render.compile_param_renderer`).

The JAX package runs these loops as a `while_loop` and a `scan`; here they
are Python loops whose condition costs one host read per step or bounce
(the live-lane count, which the refill needs as well), and the stream
position, the drain cursor and the pixel history are host integers.
`argsort` is stable, as `jnp.argsort` is.  The camera, the scatter and the
roulette draw from a `torch.Generator` seeded with the chunk's base seed,
so a chunk is deterministic on the CPU for one seed and agrees with the
JAX package statistically (on a CUDA device the ring's `index_add_` sums in
no fixed order).  Not ported: the TPU packet rows (`hit_sub`).
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import numpy as np
import torch

from ..core import rng, vec
from ..core.camera import Camera
from ..core.config import RenderSettings
from ..ops import cuda_trace
from ..scene import materials
from ..scene.types import Scene
from . import diff
from .intersect import HitRecord


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 x to every third bit (morton)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _sort_keys(o: torch.Tensor, d: torch.Tensor, alive: torch.Tensor,
               lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int32 sort key `dead << 30 | octant << 21 | morton`: terminated rays
    last, live rays grouped by direction octant, then by a 7-bit-per-axis
    morton code of the origin within [lo, hi]."""
    i32 = torch.int32
    okt = (((d[:, 0] < 0).to(i32) << 2) | ((d[:, 1] < 0).to(i32) << 1)
           | (d[:, 2] < 0).to(i32))
    q = torch.clamp((o - lo) / (hi - lo), 0.0, 1.0)
    cell = torch.clamp((q * 128.0).to(i32), 0, 127)
    morton = (_part1by2(cell[:, 0]) | (_part1by2(cell[:, 1]) << 1)
              | (_part1by2(cell[:, 2]) << 2))
    return ((~alive).to(i32) << 30) | (okt << 21) | morton


def pack_attr_table(scene: Scene, tri_perm: Optional[np.ndarray] = None,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """(S, 16) float32 per-slot winner attributes for `resolve_hit_packed`
    (`wavefront.pack_attr_table`, :86-118), indexed by the hit kernel's
    triangle slot (`tri_perm` maps a slot to its triangle, -1 on a pad
    slot, as `SceneBake.tri_perm`): n0 n1 n2 (the face normal cross(e2, e1)
    thrice for a mesh without vertex normals) | uv0 uv1 uv2 | mat_id; a pad
    slot's row is 0.  A scene without triangles gets the one zero row the
    resolve gathers (the hit kernel never sets is_tri there)."""
    tr = scene.triangles
    perm = np.zeros(0, np.int32) if tri_perm is None else np.asarray(tri_perm)
    if not len(perm):
        if tr.active.any():
            raise ValueError("a scene with triangles needs the hit tier's "
                             "tri_perm")
        return torch.zeros((1, 16), dtype=torch.float32, device=device)
    has = np.asarray(tr.has_vn)[:, None]
    face = np.cross(np.asarray(tr.e2, np.float32),
                    np.asarray(tr.e1, np.float32))
    attr = np.concatenate([
        np.where(has, tr.n0, face), np.where(has, tr.n1, face),
        np.where(has, tr.n2, face), tr.uv0, tr.uv1, tr.uv2,
        np.asarray(tr.mat_id, np.float32)[:, None]], axis=1)
    out = attr[np.clip(perm, 0, len(attr) - 1)].astype(np.float32)
    out[perm < 0] = 0.0
    return torch.as_tensor(out, device=device)


def resolve_hit_packed(attr_slot: torch.Tensor, packed: torch.Tensor,
                       p: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       normal: torch.Tensor, slot: torch.Tensor,
                       d: torch.Tensor) -> HitRecord:
    """Hit-kernel outputs to a HitRecord (`wavefront.resolve_hit_packed`):
    a triangle winner's vertex normal, uv and material come from its slot's
    row of `attr_slot` by barycentric interpolation; other winners arrive
    resolved (normal faced and normalized, uv final, mat in the word)."""
    hit = (packed & cuda_trace.HIT_BIT) != 0
    front_nt = (packed & cuda_trace.FRONT_BIT) != 0
    is_tri = (packed & cuda_trace.TRI_BIT) != 0
    a = attr_slot[torch.clamp(slot.long(), 0, attr_slot.shape[0] - 1)]
    w0 = (1.0 - u - v)[:, None]
    vert_n = (w0 * a[:, 0:3] + u[:, None] * a[:, 3:6]
              + v[:, None] * a[:, 6:9])
    front_t = vec.dot(d, vert_n) < 0.0
    n_t = vec.unit(vec.where(front_t, vert_n, -vert_n))
    uv_t = (w0 * a[:, 9:11] + u[:, None] * a[:, 11:13]
            + v[:, None] * a[:, 13:15])
    mat = torch.where(is_tri, a[:, 15].to(torch.int32), packed & 0xFFFF)
    return HitRecord(hit=hit, t=torch.zeros_like(u), p=p,
                     normal=vec.where(is_tri, n_t, normal),
                     front_face=torch.where(is_tri, front_t, front_nt),
                     u=torch.where(is_tri, uv_t[:, 0], u),
                     v=torch.where(is_tri, uv_t[:, 1], v), mat_id=mat)


def _world_box(tracer: cuda_trace.Tracer, device: torch.device) -> tuple:
    """The morton keys' box: the tracer's world bounds, at least 1e-6 wide."""
    lo = torch.as_tensor(tracer.world_lo, device=device)
    hi = lo + torch.clamp(torch.as_tensor(tracer.world_hi, device=device)
                          - lo, min=1e-6)
    return lo, hi


def make_trace_wave(scene: Scene, tracer: cuda_trace.Tracer, max_depth: int,
                    t_min: float, rr_start: int = 0,
                    device: torch.device | str = "cuda"
                    ) -> Callable[..., torch.Tensor]:
    """Bounce-synchronous sorted wavefront for one wave of rays
    (`wavefront.make_trace_wave`, :189-277): returns `trace_wave(o, d, tm,
    gen) -> ((n, 3) radiance in the rays' order, bounces traced)`, drawing
    the scatter and the roulette from `gen`.  Bounce 0 runs in the given
    (pixel) order;
    each later bounce sorts the lanes by `_sort_keys` with one packed
    gather of their state, and a bounce with no live lane ends the wave
    (one host read a bounce)."""
    device = torch.device(device)
    hit = tracer.bind_hit(t_min)  # raises without supports_hit
    params = diff.get_params(scene, device)
    bg = torch.as_tensor(np.asarray(scene.background), dtype=torch.float32,
                         device=device)
    lo, hi = _world_box(tracer, device)
    attr_slot = pack_attr_table(scene, tracer.bake.tri_perm, device)

    def bounce_shade(o, d, tm, thr, rad, alive, gen, depth: int):
        """One closest hit and the torch half of the bounce, as the regen
        step's (`integrator.trace`'s update, `render.h:55-81`)."""
        hr = hit(o, d, tm, alive)
        rec = resolve_hit_packed(attr_slot, *hr, d)
        miss = (hr.packed & cuda_trace.MISS_BIT) != 0
        sc = materials.scatter(scene, params, gen, d, rec.p, rec.normal,
                               rec.front_face, rec.u, rec.v, rec.mat_id)
        rad = rad + torch.where(miss[:, None], thr * bg, 0.0)
        rad = rad + torch.where(rec.hit[:, None], thr * sc.emitted, 0.0)
        cont = rec.hit & sc.ok
        thr = torch.where(cont[:, None], thr * sc.attenuation, thr)
        if rr_start > 0 and depth >= rr_start:
            p_s = torch.clamp(thr.amax(dim=-1), 0.05, 1.0)
            survive = rng.uniform(gen, (thr.shape[0],)) < p_s
            thr = torch.where((cont & survive)[:, None],
                              thr * (1.0 / p_s)[:, None], thr)
            cont = cont & survive
        o = vec.where(rec.hit, rec.p, o).contiguous()
        d = vec.where(rec.hit, sc.direction, d).contiguous()
        return o, d, thr, rad, cont

    def trace_wave(o: torch.Tensor, d: torch.Tensor, tm: torch.Tensor,
                   gen: torch.Generator) -> tuple[torch.Tensor, int]:
        n = o.shape[0]
        thr = torch.ones((n, 3), dtype=torch.float32, device=device)
        rad = torch.zeros((n, 3), dtype=torch.float32, device=device)
        perm = torch.arange(n, dtype=torch.float32, device=device)
        alive = torch.ones(n, dtype=torch.bool, device=device)
        tm = tm.contiguous()
        # bounce 0 unsorted: camera rays are pixel-coherent already
        o, d, thr, rad, alive = bounce_shade(o.contiguous(), d.contiguous(),
                                             tm, thr, rad, alive, gen, 0)
        bounces = 1
        for depth in range(1, max_depth):
            if not bool(alive.any()):  # the bounce's one host read
                break
            order = torch.argsort(_sort_keys(o, d, alive, lo, hi),
                                  stable=True)
            pay = torch.cat([o, d, tm[:, None], thr, rad, perm[:, None]],
                            dim=1)[order]
            o, d = pay[:, 0:3].contiguous(), pay[:, 3:6].contiguous()
            tm, thr, rad = pay[:, 6].contiguous(), pay[:, 7:10], pay[:, 10:13]
            perm, alive = pay[:, 13], alive[order]
            o, d, thr, rad, alive = bounce_shade(o, d, tm, thr, rad, alive,
                                                 gen, depth)
            bounces += 1
        # undo the accumulated permutation (one scatter per wave)
        out = torch.zeros((n, 3), dtype=torch.float32, device=device)
        out[perm.long()] = rad
        return out, bounces

    return trace_wave


def make_record_trace_wave(scene: Scene, tracer: cuda_trace.Tracer,
                           max_depth: int, t_min: float, rr_start: int = 0,
                           device: torch.device | str = "cuda"
                           ) -> Callable[..., tuple]:
    """Detached record walk of one wave of rays on the sorted wavefront
    (`wavefront.make_record_trace_wave`, :280-398): returns
    `trace_record(o, d, tm, gen) -> (planes, bounces)`, the record planes of
    `Tracer.walk_packed`'s contract in the rays' (pixel) order, drawn from
    `gen`, and the bounces traced (one hit launch each).

    planes = (packed (D, n) int32, [px, py, pz,] [u, v,] [scale]): per
    bounce the word `mat | hit<<16 | cont<<17 | miss<<18`, the hit point
    (0 where the bounce did not hit) when `tracer.need_p`, the resolved uv
    (the hit kernel's, 0 on a miss) when `tracer.need_uv`, and with
    `rr_start > 0` the russian-roulette scale 1/p of the lanes that
    survive it (1 elsewhere, and on a bounce no lane reached).  The walk
    shades nothing that depends on the parameters: the throughput that sets
    the roulette's probabilities is the scene's own (baked) one, so the
    decisions and the scale are constants of the parameters, and
    `integrator.shade_packed(..., need_scale=rr_start > 0)` replays the
    throughput differentiably.  Bounce 0 runs in the given order; each
    later bounce sorts the lanes by `_sort_keys` with one packed gather and
    writes its record row back to pixel order with one scatter; a bounce
    with no live lane ends the walk (one host read a bounce)."""
    device = torch.device(device)
    hit = tracer.bind_hit(t_min)  # raises without supports_hit
    params = diff.get_params(scene, device)
    lo, hi = _world_box(tracer, device)
    attr_slot = pack_attr_table(scene, tracer.bake.tri_perm, device)
    need_p, need_uv = tracer.need_p, tracer.need_uv

    def bounce_record(o, d, tm, thr, alive, gen, depth: int):
        """One detached bounce: closest hit and scattered direction, and the
        bounce's record row (n, 7): the word, p, u, v, scale."""
        hr = hit(o, d, tm, alive)
        rec = resolve_hit_packed(attr_slot, *hr, d)
        miss = (hr.packed & cuda_trace.MISS_BIT) != 0
        sc = materials.scatter(scene, params, gen, d, rec.p, rec.normal,
                               rec.front_face, rec.u, rec.v, rec.mat_id)
        cont = rec.hit & sc.ok
        thr = torch.where(cont[:, None], thr * sc.attenuation, thr)
        scale = torch.ones_like(tm)
        if rr_start > 0 and depth >= rr_start:
            p_s = torch.clamp(thr.amax(dim=-1), 0.05, 1.0)
            survive = rng.uniform(gen, (thr.shape[0],)) < p_s
            scale = torch.where(cont & survive, 1.0 / p_s, 1.0)
            thr = thr * scale[:, None]
            cont = cont & survive
        word = (rec.mat_id | (rec.hit.to(torch.int32) << 16)
                | (cont.to(torch.int32) << 17) | (miss.to(torch.int32) << 18))
        row = torch.cat([word.to(torch.float32)[:, None],
                         torch.where(rec.hit[:, None], rec.p, 0.0),
                         rec.u[:, None], rec.v[:, None], scale[:, None]],
                        dim=1)
        o = vec.where(rec.hit, rec.p, o).contiguous()
        d = vec.where(rec.hit, sc.direction, d).contiguous()
        return o, d, thr, cont, row

    def trace_record(o: torch.Tensor, d: torch.Tensor, tm: torch.Tensor,
                     gen: torch.Generator) -> tuple[tuple, int]:
        n = o.shape[0]
        # a bounce no lane reaches records 0 and a scale of 1
        rows = torch.zeros((max_depth, n, 7), dtype=torch.float32,
                           device=device)
        rows[..., 6] = 1.0
        thr = torch.ones((n, 3), dtype=torch.float32, device=device)
        perm = torch.arange(n, dtype=torch.float32, device=device)
        alive = torch.ones(n, dtype=torch.bool, device=device)
        tm = tm.contiguous()
        bounces = 0
        for depth in range(max_depth):
            if depth > 0:
                if not bool(alive.any()):  # the bounce's one host read
                    break
                order = torch.argsort(_sort_keys(o, d, alive, lo, hi),
                                      stable=True)
                pay = torch.cat([o, d, tm[:, None], thr, perm[:, None]],
                                dim=1)[order]
                o, d = pay[:, 0:3].contiguous(), pay[:, 3:6].contiguous()
                tm, thr = pay[:, 6].contiguous(), pay[:, 7:10]
                perm = pay[:, 10]
                alive = alive[order]
            o, d, thr, alive, row = bounce_record(o, d, tm, thr, alive, gen,
                                                  depth)
            rows[depth, perm.long()] = row  # back to pixel order
            bounces += 1
        planes = [rows[..., 0].to(torch.int32)]
        if need_p:
            planes += [rows[..., 1], rows[..., 2], rows[..., 3]]
        if need_uv:
            planes += [rows[..., 4], rows[..., 5]]
        if rr_start > 0:
            planes.append(rows[..., 6])
        return tuple(planes), bounces

    return trace_record


def compile_wavefront_renderer(scene: Scene, camera: Camera,
                               settings: RenderSettings,
                               tracer: cuda_trace.Tracer | None = None,
                               debug_stats: bool = False,
                               device: torch.device | str = "cuda"
                               ) -> Callable[[int], torch.Tensor]:
    """Bounce-synchronous wavefront chunk (`compile_wavefront_renderer`,
    :400-450): base seed -> (npix_pad, 3) float32 radiance sums over
    `spp_per_chunk` samples, in waves of `ray_batch` pixels as the
    megakernel route splits them, each wave traced by `make_trace_wave`.
    Its estimator is the regen route's.  The waves follow
    `render.chunk_sums`'s schedule: wave (s, bid) draws its camera rays
    (jitter, lens, shutter time) and a seed from a generator seeded with
    `wave_seed(base, s, bid)`, and its scatter and roulette from a
    generator seeded with that seed, so `make_record_trace_wave` under the
    same schedule walks the same paths.  With `debug_stats` a chunk returns
    (sums, {"iterations": bounces traced, each one hit launch and one host
    read}).  Raises ValueError for a scene with media
    (`Tracer.supports_hit`)."""
    from .render import chunk_sums

    device = torch.device(device)
    if tracer is None:
        tracer = cuda_trace.Tracer(scene, device)
    trace_wave = make_trace_wave(scene, tracer, settings.max_depth,
                                 settings.t_min, settings.rr_start, device)
    bounces = [0]

    def trace_fn(_scene, o, d, tm, seed: int) -> torch.Tensor:
        rad, traced = trace_wave(
            o, d, tm, torch.Generator(device=device).manual_seed(seed))
        bounces[0] += traced
        return rad

    def chunk(base: int) -> torch.Tensor:
        bounces[0] = 0
        sums = chunk_sums(scene, camera, settings, int(base), trace_fn,
                          device)
        if debug_stats:
            return sums, {"iterations": bounces[0]}
        return sums

    chunk.engine_name = "wavefront"
    return chunk


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0)


def compile_regen_renderer(scene: Scene, camera: Camera,
                           settings: RenderSettings,
                           tracer: cuda_trace.Tracer | None = None,
                           debug_stats: bool = False,
                           device: torch.device | str = "cuda",
                           _local: Optional[tuple] = None
                           ) -> Callable[[int], torch.Tensor]:
    """Regenerative wavefront chunk: base seed -> (npix_pad, 3) float32
    radiance sums over `spp_per_chunk` samples (npix_pad as
    `render._grid_geometry`), on `device`.  With `debug_stats` a chunk
    returns (sums, {"iterations": steps, "stream": rays issued}).  Raises
    ValueError for a scene with media (`Tracer.supports_hit`).

    _local: for `parallel.render.compile_sharded_renderer`, a (npix_local,
    spp_local) pair: the returned `body(seed, pix_lo)` renders one rank's
    span of npix_local pixels from global pixel `pix_lo` at spp_local
    samples, with its own stream seeded with `seed`, and returns the raw
    sums, rows padded to the ring's drain block (`wavefront.py:504-509`,
    `:519-537`, `:666-684`)."""
    from .render import _grid_geometry

    device = torch.device(device)
    if tracer is None:
        tracer = cuda_trace.Tracer(scene, device)
    hit = tracer.bind_hit(settings.t_min)  # raises without supports_hit
    h, w = settings.image_height, settings.image_width
    npix, n, spp = h * w, settings.ray_batch, settings.spp_per_chunk
    if _local is not None:
        npix, spp = _local
    max_depth, rr_start = settings.max_depth, settings.rr_start
    cam = camera.to(device)
    params = diff.get_params(scene, device)
    bg = torch.as_tensor(np.asarray(scene.background), dtype=torch.float32,
                         device=device)
    lo, hi = _world_box(tracer, device)
    attr_slot = pack_attr_table(scene, tracer.bake.tri_perm, device)

    adv = -(-n // spp)                      # most pixels a step can issue
    ring_w = _pow2_at_least((max_depth + 4) * adv)
    drain_k = ring_w // 16                  # aligned drain block (>= adv)
    npix_pad_out = _grid_geometry(settings)[3]
    npix_pad = -(-npix // drain_k) * drain_k
    total = npix_pad * spp                  # stream length (rays)
    inv_w = 1.0 / max(w - 1, 1)
    inv_h = 1.0 / max(h - 1, 1)
    lane = torch.arange(n, dtype=torch.int64, device=device)

    def body(seed: int, pix_lo: int):
        gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
        fb = torch.zeros((npix_pad, 3), dtype=torch.float32, device=device)
        ring = torch.zeros((ring_w, 3), dtype=torch.float32, device=device)
        pay = torch.zeros((n, 15), dtype=torch.float32, device=device)
        pay[:, 3] = 1.0                     # unit-ish directions for padding
        alive = torch.zeros(n, dtype=torch.bool, device=device)
        hist = collections.deque([0] * max_depth)
        steps = stream_next = drained = 0
        while True:
            n_live = int(alive.sum())       # the step's one host read
            if stream_next >= total and n_live == 0:
                break
            # 1. sort: dead lanes to the tail, live ones by octant, morton
            order = torch.argsort(_sort_keys(pay[:, 0:3], pay[:, 3:6], alive,
                                             lo, hi), stable=True)
            pay, alive = pay[order], alive[order]

            # 2. refill the dead tail with consecutive stream rays
            s_idx = stream_next + (lane - n_live)
            new = ~alive & (s_idx < total) & (lane >= n_live)
            pix_new = torch.clamp(torch.div(s_idx, spp, rounding_mode="floor"),
                                  0, npix_pad - 1)
            g = pix_lo + pix_new        # the global pixel, for the camera
            row = torch.clamp(torch.div(g, w, rounding_mode="floor"),
                              max=h - 1)
            col = torch.clamp(g % w, max=w - 1)
            jit2 = rng.uniform(gen, (n, 2))
            su = (col.to(torch.float32) + jit2[:, 0]) * inv_w
            sv = ((h - 1 - row).to(torch.float32) + jit2[:, 1]) * inv_h
            o_n, d_n, tm_n = cam.get_rays(gen, su, sv)
            newf = new[:, None].to(torch.float32)
            o = vec.where(new, o_n, pay[:, 0:3])
            d = vec.where(new, d_n, pay[:, 3:6])
            tm = torch.where(new, tm_n, pay[:, 6])
            thr = (1.0 - newf) * pay[:, 7:10] + newf
            rad = (1.0 - newf) * pay[:, 10:13]
            pix = torch.where(new, pix_new, pay[:, 13].to(torch.int64))
            depth = torch.where(new, 0, pay[:, 14].to(torch.int64))
            alive = alive | new
            n_refill = min(max(n - n_live, 0), total - stream_next)

            # 3. one closest hit, then the torch half of the bounce
            hr = hit(o, d, tm, alive)
            rec = resolve_hit_packed(attr_slot, *hr, d)
            miss = (hr.packed & cuda_trace.MISS_BIT) != 0
            sc = materials.scatter(scene, params, gen, d, rec.p, rec.normal,
                                   rec.front_face, rec.u, rec.v, rec.mat_id)
            rad = rad + torch.where(miss[:, None], thr * bg, 0.0)
            rad = rad + torch.where(rec.hit[:, None], thr * sc.emitted, 0.0)
            cont = rec.hit & sc.ok
            thr = torch.where(cont[:, None], thr * sc.attenuation, thr)
            if rr_start > 0:
                p_s = torch.clamp(thr.amax(dim=-1), 0.05, 1.0)
                do_rr = depth >= rr_start
                survive = ~do_rr | (rng.uniform(gen, (n,)) < p_s)
                scale = torch.where(do_rr & survive, 1.0 / p_s, 1.0)
                thr = torch.where(cont[:, None], thr * scale[:, None], thr)
                cont = cont & survive
            depth = depth + 1
            cont = cont & (depth < max_depth)
            o = vec.where(rec.hit, rec.p, o)
            d = vec.where(rec.hit, sc.direction, d)

            # 4. deposit the rays that ended into the ring
            died = alive & ~cont
            ring.index_add_(0, pix & (ring_w - 1),
                            torch.where(died[:, None], rad, 0.0))
            alive = cont

            # 5. drain final ring blocks: pixels below hist[0] // spp were
            #    issued max_depth steps ago, so no live ray reaches them
            safe_pix = hist.popleft() // spp
            hist.append(stream_next + n_refill)
            for _ in range(2):
                if drained + drain_k <= safe_pix:
                    k0 = drained % ring_w
                    fb[drained:drained + drain_k] = ring[k0:k0 + drain_k]
                    ring[k0:k0 + drain_k] = 0.0
                    drained += drain_k

            pay = torch.cat([o, d, tm[:, None], thr, rad,
                             pix.to(torch.float32)[:, None],
                             depth.to(torch.float32)[:, None]], dim=1)
            stream_next += n_refill
            steps += 1

        # final flush: ring row r holds at most one undrained pixel,
        # drained + ((r - drained) mod ring_w)
        rows = torch.arange(ring_w, dtype=torch.int64, device=device)
        p_cand = drained + (rows - drained) % ring_w
        ok = p_cand < npix_pad
        fb.index_add_(0, torch.where(ok, p_cand, 0),
                      torch.where(ok[:, None], ring, 0.0))
        return fb, {"iterations": steps, "stream": stream_next}

    if _local is not None:
        return lambda seed, pix_lo: body(seed, pix_lo)[0]

    def chunk(base: int):
        fb, stats = body(base, 0)
        chunk.steps += stats["iterations"]
        if npix_pad_out <= npix_pad:
            fb = fb[:npix_pad_out]
        else:
            fb = torch.cat([fb, torch.zeros((npix_pad_out - npix_pad, 3),
                                            dtype=torch.float32,
                                            device=device)])
        return (fb, stats) if debug_stats else fb

    chunk.engine_name = "regen"
    chunk.steps = 0  # steps of every chunk so far
    return chunk
