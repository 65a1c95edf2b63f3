"""The XLA engine's path tracer, and the shade of recorded bounces.

Counterpart of `raytracing_gpu_tpu/engine/integrator.py`.

The XLA engine (`trace`, `trace_bounces`, `trace_diff`) walks the whole
batch one bounce at a time in torch ops over `intersect.closest_hit`,
with russian roulette in `trace`; a bounce whose lanes are all dead ends
the walk (one host read a bounce).  Each bounce takes its randomness, the
media's uniforms, the scatter's four draws and the roulette's uniform,
from a `torch.Generator` or from a per-bounce draw source (`BounceDraws`),
for example one filled from the JAX package's keys.

Phase 2 of the differentiable render is `shade_radiance`.  Phase 1, the
detached path walk, is `trace_bounces`, the record kernel
(`ops/cuda_trace.py` `Tracer.walk_packed_pixels`, `Tracer.walk_packed`) or
the wavefront record walk (`engine/wavefront.py` `make_record_trace_wave`):
per bounce it packs the material id and the hit/cont/miss masks into one
int32 word, with the hit point beside it when a texture needs it and, on
the wavefront walk with russian roulette, the 1/p survival scale.
Everything that depends on the parameters happens in the shade, in torch
ops that autograd can follow.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core import rng, vec
from ..scene import materials as materials_mod
from ..scene.types import Scene, host_table
from . import intersect


class BounceDraws(NamedTuple):
    """The randomness of one bounce of the XLA engine: the media's
    uniforms (`closest_hit`), the scatter's draws and, with russian
    roulette, one (N,) uniform (`trace`'s `fold(kb, 0x5252)`)."""

    media: intersect.MediaDraws
    scatter: materials_mod.ScatterDraws
    rr: Optional[torch.Tensor] = None


def _draw_source(geom: intersect.Geometry,
                 generator: Optional[torch.Generator],
                 draws: Optional[Callable[[int], BounceDraws]], n: int,
                 rr: bool) -> Callable[[int], BounceDraws]:
    """`draws` when given, else a draw source for n rays from `generator`:
    each bounce draws the media's uniforms, then the scatter's, then the
    roulette's."""
    if draws is not None:
        return draws
    if generator is None:
        raise ValueError("pass a torch.Generator or a draw source")

    def draw(_depth: int) -> BounceDraws:
        media = intersect.draw_media(generator, geom, n)
        scatter = materials_mod.draw_scatter(generator, n)
        return BounceDraws(media, scatter,
                           rng.uniform(generator, (n,)) if rr else None)

    return draw


def trace(scene: Scene, origins: torch.Tensor, directions: torch.Tensor,
          times: torch.Tensor, generator: Optional[torch.Generator] = None,
          draws: Optional[Callable[[int], BounceDraws]] = None,
          max_depth: int = 50, t_min: float = 0.001, rr_start: int = 0,
          params: Optional[dict] = None,
          geom: Optional[intersect.Geometry] = None) -> torch.Tensor:
    """Radiance (N, 3) along each ray (`integrator.trace`; the reference's
    `color_f`, `render.h:55-81`): at each bounce the closest hit; on a
    miss the background and the end; on a hit its emission, then the
    scattered ray, or the end where the material absorbs.  A path still
    alive at `max_depth` adds nothing more.

    With `rr_start > 0`, russian roulette from that bounce: a path goes on
    with probability p = clip(max(throughput), 0.05, 1) and is reweighted
    by 1/p.  `draws(depth)` gives each bounce's `BounceDraws`, else they
    come from `generator`; `params` are the shading parameters
    (`engine.diff.get_params`, the scene's own when None); `geom` is
    `intersect.geometry(scene, device)`, made here when not given."""
    dev, n = origins.device, origins.shape[0]
    if geom is None:
        geom = intersect.geometry(scene, dev)
    if params is None:
        from .diff import get_params
        params = get_params(scene, dev)
    draw = _draw_source(geom, generator, draws, n, rr_start > 0)
    bg = host_table(scene.background, dev, torch.float32)
    o, d, tm = origins, directions, times
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for depth in range(max_depth):
        if not bool(alive.any()):  # every path has ended
            break
        bd = draw(depth)
        rec = intersect.closest_hit(scene, o, d, tm, draws=bd.media,
                                    t_min=t_min, geom=geom)
        miss = alive & ~rec.hit
        radiance = radiance + torch.where(miss[:, None], throughput * bg,
                                          0.0)
        sc = materials_mod.scatter(scene, params, None, d, rec.p, rec.normal,
                                   rec.front_face, rec.u, rec.v, rec.mat_id,
                                   draws=bd.scatter)
        hit_lane = alive & rec.hit
        radiance = radiance + torch.where(hit_lane[:, None],
                                          throughput * sc.emitted, 0.0)
        cont = hit_lane & sc.ok
        throughput = torch.where(cont[:, None], throughput * sc.attenuation,
                                 throughput)
        if 0 < rr_start <= depth:
            # survive w.p. p, survivors reweighted by 1/p
            p = torch.clamp(throughput.amax(dim=-1), 0.05, 1.0)
            survive = bd.rr < p
            scale = torch.where(survive, 1.0 / p, 1.0)
            throughput = torch.where(cont[:, None],
                                     throughput * scale[:, None], throughput)
            cont = cont & survive
        o = vec.where(hit_lane, rec.p, o)
        d = vec.where(hit_lane, sc.direction, d)
        alive = cont
    return radiance


class BounceData(NamedTuple):
    """Per-bounce shading inputs recorded by the path walk, stacked (D, ...)."""

    mat_id: torch.Tensor  # (D, N) int32
    u: torch.Tensor       # (D, N)
    v: torch.Tensor       # (D, N)
    p: torch.Tensor       # (D, N, 3)
    hit: torch.Tensor     # (D, N) bool: hit this bounce while alive
    cont: torch.Tensor    # (D, N) bool: the path continued after this bounce
    miss: torch.Tensor    # (D, N) bool: escaped to the background
    scale: torch.Tensor | None = None  # (D, N) detached 1/p of russian
    #                                    roulette, None: no roulette


def unpack_walk(planes, need_p: bool, need_uv: bool,
                need_scale: bool = False) -> BounceData:
    """Raw record planes -> BounceData.

    planes = (packed (D, N) int32, [px, py, pz,] [u, v,] [scale]): the
    masks live in bits 16-18 of the packed plane, absent p and uv planes
    become zeros here, and the trailing scale plane (the wavefront record
    walk with russian roulette) is None when absent.
    """
    packed = planes[0]
    max_depth, n = packed.shape
    zeros = torch.zeros((max_depth, n), dtype=torch.float32,
                        device=packed.device)
    i = 1
    if need_p:
        p = torch.stack([planes[i], planes[i + 1], planes[i + 2]], dim=-1)
        i += 3
    else:
        p = torch.zeros((max_depth, n, 3), dtype=torch.float32,
                        device=packed.device)
    if need_uv:
        u, v = planes[i], planes[i + 1]
        i += 2
    else:
        u = v = zeros
    return BounceData(
        mat_id=packed & 0xFFFF, u=u, v=v, p=p,
        hit=(packed & (1 << 16)) != 0, cont=(packed & (1 << 17)) != 0,
        miss=(packed & (1 << 18)) != 0,
        scale=planes[i] if need_scale else None,
    )


def shade_radiance(scene: Scene, params: dict, data: BounceData
                   ) -> torch.Tensor:
    """Differentiable radiance (N, 3) over recorded bounces.

    L = sum_b T_b * E_b with E_b = miss_b * background + hit_b * emit_b and
    T_{b+1} = T_b * (cont_b * att_b + (1 - cont_b)) * scale_b: the
    mask-multiply form of `integrator.shade_radiance`, in its order of
    operations; scale_b, the detached russian-roulette 1/p, is 1 without
    a scale plane.  Shading runs once over the flattened (D * N) hits, as the
    JAX package does for image scenes: the same values per hit, in one call
    instead of D.
    """
    depth, n = data.mat_id.shape
    dev = data.mat_id.device
    h_all = data.hit.to(torch.float32)[..., None]   # (D, N, 1)
    m_all = data.miss.to(torch.float32)[..., None]
    c_all = data.cont.to(torch.float32)[..., None]
    att_all, emit_all = materials_mod.shade(
        scene, params, data.mat_id.reshape(-1), data.u.reshape(-1),
        data.v.reshape(-1), data.p.reshape(-1, 3))
    att_all = att_all.reshape(depth, n, 3)
    emit_all = emit_all.reshape(depth, n, 3)
    bg = host_table(scene.background, dev, torch.float32)

    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for b in range(depth):
        h, m, c = h_all[b], m_all[b], c_all[b]
        radiance = radiance + throughput * (m * bg + h * emit_all[b])
        throughput = throughput * (c * att_all[b] + (1.0 - c))
        if data.scale is not None:
            throughput = throughput * data.scale[b][..., None]
    return radiance


def shade_packed(scene: Scene, params: dict, *planes, need_p: bool,
                 need_uv: bool, need_scale: bool = False) -> torch.Tensor:
    """Phase 2 over raw record planes: unpack, then shade."""
    return shade_radiance(scene, params,
                          unpack_walk(planes, need_p, need_uv, need_scale))


def trace_bounces(scene: Scene, origins: torch.Tensor,
                  directions: torch.Tensor, times: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Callable[[int], BounceDraws]] = None,
                  max_depth: int = 50, t_min: float = 0.001,
                  geom: Optional[intersect.Geometry] = None) -> BounceData:
    """Phase 1 of the differentiable split (`integrator.trace_bounces`):
    walk the paths, fully detached, and record what each bounce's shade
    needs.  The draws are `trace`'s; once every path has ended the rest
    of the bounces record nothing (zeros), as the JAX walk's dead bounce
    does."""
    dev, n = origins.device, origins.shape[0]
    if geom is None:
        geom = intersect.geometry(scene, dev)
    draw = _draw_source(geom, generator, draws, n, False)
    o, d, tm = origins.detach(), directions.detach(), times.detach()
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    rows = []
    with torch.no_grad():
        for depth in range(max_depth):
            if not bool(alive.any()):
                break
            bd = draw(depth)
            rec = intersect.closest_hit(scene, o, d, tm, draws=bd.media,
                                        t_min=t_min, geom=geom)
            direction, ok = materials_mod.scatter_direction(
                scene, bd.scatter, d, rec.normal, rec.front_face, rec.mat_id)
            hit_lane = alive & rec.hit
            cont = hit_lane & ok
            rows.append((rec.mat_id, rec.u, rec.v, rec.p, hit_lane, cont,
                         alive & ~rec.hit))
            o = vec.where(hit_lane, rec.p, o)
            d = vec.where(hit_lane, direction, d)
            alive = cont
    dead = max_depth - len(rows)
    fields = []
    for k, ref in enumerate(rows[0]):
        x = torch.stack([r[k] for r in rows])
        pad = torch.zeros((dead,) + tuple(ref.shape), dtype=ref.dtype,
                          device=dev)
        fields.append(torch.cat([x, pad]) if dead else x)
    return BounceData(*fields)


def trace_diff(scene: Scene, params: dict, origins: torch.Tensor,
               directions: torch.Tensor, times: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Callable[[int], BounceDraws]] = None,
               max_depth: int = 50, t_min: float = 0.001, rr_start: int = 0,
               geom: Optional[intersect.Geometry] = None) -> torch.Tensor:
    """Differentiable radiance (N, 3) (`integrator.trace_diff`): `trace`'s
    estimator with its draws, as the detached walk `trace_bounces` and the
    shade `shade_radiance`, so autograd sees only the shade.  Russian
    roulette is a forward feature: `rr_start` must be 0 (ValueError)."""
    if rr_start:
        raise ValueError("russian roulette is not supported on the diff "
                         "path (its walk carries no throughput)")
    data = trace_bounces(scene, origins, directions, times, generator, draws,
                         max_depth=max_depth, t_min=t_min, geom=geom)
    return shade_radiance(scene, params, data)
