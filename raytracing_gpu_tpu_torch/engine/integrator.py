"""Phase 2 of the differentiable render: shading over recorded bounces.

Counterpart of `BounceData`, `unpack_walk`, `shade_radiance` and
`shade_packed` in `raytracing_gpu_tpu/engine/integrator.py`.  Phase 1, the
detached path walk, is the record kernel (`ops/cuda_trace.py`
`Tracer.walk_packed_pixels`, `Tracer.walk_packed`) or the wavefront record
walk (`engine/wavefront.py` `make_record_trace_wave`): per bounce it packs
the material id and the hit/cont/miss masks into one int32 word, with the
hit point beside it when a texture needs it and, on the wavefront walk
with russian roulette, the 1/p survival scale.  Everything that depends on
the parameters happens here, in torch ops that autograd can follow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene import materials as materials_mod
from ..scene.types import Scene, host_table


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
