"""Material scatter and shading per hit.

Counterpart of `raytracing_gpu_tpu/scene/materials.py`: `scatter_direction`
samples the scattered direction of every material kind for the whole batch
and selects by the winner's kind (reference `material.h:16-138`), with the
draws from a `torch.Generator` or given as tensors; `shade` (`_fast_shade`)
gives (attenuation, emitted), which depend on the parameters only through
the texture colors, so gradients of an image flow into them.  The
megakernels scatter in the kernel from their PCG stream; the wavefront
drivers (`engine/wavefront.py`) scatter here.

The material kinds and the texture bindings are the scene's host numpy
arrays, so every per-material branch below is decided on the host, as the
JAX package decides it at trace time on a baked scene.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import rng, vec
from .textures import eval_texture
from .types import (DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC, METAL, TEX_CHECKER,
                    TEX_SOLID, Scene, host_table)

_UNROLL_MAX = 32  # materials up to which the per-material select is unrolled


def _fast_shade(scene: Scene, params: dict, mat_id: torch.Tensor,
                p: torch.Tensor):
    """(attenuation, emitted), each (N, 3), when every texture a material
    binds is solid or checker; else None (`materials._fast_shade`).

    Up to 32 materials: an unrolled per-material select, M masked
    multiply-adds over the hits.  Above: one one-hot product of the hits
    against a per-material feature table [c1, c2, scale, is_checker,
    is_diel, is_light].  Each one-hot row has a single 1, so the product is
    exact in float32 in any summation order (it needs full float32, not
    TF32, which is torch's default for `matmul`).
    """
    mats, tx = scene.materials, scene.textures
    mkind = np.asarray(mats.kind)
    mtex = np.asarray(mats.tex_id)
    tkind = np.asarray(tx.kind)[mtex]
    if not np.all(np.isin(tkind, (TEX_SOLID, TEX_CHECKER))):
        return None
    c1_all, c2_all = params["tex_c1"], params["tex_c2"]

    if mkind.shape[0] <= _UNROLL_MAX:
        scale_np = np.asarray(tx.scale)
        att = torch.zeros(mat_id.shape + (3,), dtype=torch.float32,
                          device=p.device)
        emit = torch.zeros_like(att)
        for mi in range(mkind.shape[0]):
            mask = (mat_id == mi).to(torch.float32)[..., None]
            alb = c1_all[int(mtex[mi])]                    # (3,) param row
            if tkind[mi] == TEX_CHECKER:
                s = float(scale_np[mtex[mi]])  # a float32 value
                sines = (torch.sin(s * p[..., 0]) * torch.sin(s * p[..., 1])
                         * torch.sin(s * p[..., 2]))
                odd = (sines < 0.0).to(torch.float32)[..., None]
                alb = alb + odd * (c2_all[int(mtex[mi])] - alb)
            if mkind[mi] == DIELECTRIC:
                att_m = alb + (1.0 - alb)  # == 1, kept in this form so the
                # c1 gradient stays exactly zero-sum like the product path
            else:
                att_m = alb
            att = att + mask * att_m
            if mkind[mi] == DIFFUSE_LIGHT:
                emit = emit + mask * alb
        return att, emit

    idx = host_table(mtex, p.device, torch.long)
    sclm = host_table(np.asarray(tx.scale)[mtex], p.device)
    flags = host_table(np.stack([
        (tkind == TEX_CHECKER), (mkind == DIELECTRIC),
        (mkind == DIFFUSE_LIGHT),
    ], axis=1).astype(np.float32), p.device)              # (M, 3)
    table = torch.cat([c1_all[idx], c2_all[idx], sclm[:, None], flags],
                      dim=1)                               # (M, 10)
    onehot = torch.nn.functional.one_hot(mat_id.long(), table.shape[0]).to(
        table.dtype)
    feats = onehot @ table                 # (N, 10): the only per-hit lookup
    c1, c2, scale = feats[..., 0:3], feats[..., 3:6], feats[..., 6]
    is_chk, is_diel, is_light = (feats[..., 7:8], feats[..., 8:9],
                                 feats[..., 9:10])
    # mask-multiply on exact 0/1 flags, as the JAX package does
    if np.any(tkind == TEX_CHECKER):
        sines = (torch.sin(scale * p[..., 0]) * torch.sin(scale * p[..., 1])
                 * torch.sin(scale * p[..., 2]))
        odd = is_chk * (sines < 0.0).to(feats.dtype)[..., None]
        albedo = c1 + odd * (c2 - c1)
    else:
        albedo = c1
    attenuation = albedo + is_diel * (1.0 - albedo)
    emitted = is_light * albedo
    return attenuation, emitted


def shade(scene: Scene, params: dict, mat_id: torch.Tensor, u: torch.Tensor,
          v: torch.Tensor, p: torch.Tensor):
    """Differentiable shading half: (attenuation, emitted), each (N, 3),
    per hit (`materials.shade`, reference `material::scatter` attenuation +
    `material::emitted`)."""
    fast = _fast_shade(scene, params, mat_id, p)
    if fast is not None:
        return fast
    mats = scene.materials
    dev = p.device
    mat_id = mat_id.long()
    kind = host_table(mats.kind, dev)[mat_id]
    tex_id = host_table(mats.tex_id, dev)[mat_id]
    tex_color = eval_texture(scene, params, tex_id, u, v, p)
    is_diel = (kind == DIELECTRIC).to(tex_color.dtype)[..., None]
    is_light = (kind == DIFFUSE_LIGHT).to(tex_color.dtype)[..., None]
    attenuation = tex_color + is_diel * (1.0 - tex_color)
    emitted = is_light * tex_color
    return attenuation, emitted


class ScatterResult(NamedTuple):
    direction: torch.Tensor    # (N, 3) new ray direction, not normalized
    attenuation: torch.Tensor  # (N, 3)
    emitted: torch.Tensor      # (N, 3)
    ok: torch.Tensor           # (N,) bool: False when absorbed or a light


class ScatterDraws(NamedTuple):
    """The four draws of one scatter (`materials.scatter_direction`
    :59-63): a unit vector (N, 3), two points in the unit ball (N, 3) and
    one uniform (N,)."""

    unit: torch.Tensor
    sphere: torch.Tensor
    iso: torch.Tensor
    u_refl: torch.Tensor


def draw_scatter(generator: torch.Generator, n: int) -> ScatterDraws:
    """Fresh draws for n hits from `generator`."""
    return ScatterDraws(rng.unit_vector(generator, (n,)),
                        rng.in_unit_sphere(generator, (n,)),
                        rng.in_unit_sphere(generator, (n,)),
                        rng.uniform(generator, (n,)))


def scatter_direction(scene: Scene, draws: ScatterDraws,
                      in_dir: torch.Tensor, normal: torch.Tensor,
                      front_face: torch.Tensor, mat_id: torch.Tensor):
    """(direction (N, 3), ok (N,)) of every hit: the direction sampling of
    `material::scatter`, every kind computed and the winner's selected.

    normal: (N, 3) unit, faced against the ray; front_face: (N,) bool;
    mat_id: (N,) int.  Lambertian n + unit vector (material.h:16-36), metal
    reflect + fuzz * ball point, ok above the surface (:39-56), dielectric
    Schlick reflect or refract (:59-104), isotropic a ball point; a light
    ends the path.
    """
    dev = in_dir.device
    mats = scene.materials
    mat_id = mat_id.long()
    kind = host_table(mats.kind, dev)[mat_id]
    fuzz = host_table(mats.fuzz, dev)[mat_id]
    ir = host_table(mats.ir, dev)[mat_id]

    lam_dir = normal + draws.unit
    lam_dir = vec.where(vec.near_zero(lam_dir), normal, lam_dir)

    unit_dir = vec.unit(in_dir)
    refl = vec.reflect(unit_dir, normal)
    metal_dir = refl + fuzz[..., None] * draws.sphere
    metal_ok = vec.dot(metal_dir, normal) > 0.0

    ratio = torch.where(front_face, 1.0 / ir, ir)
    cos_theta = torch.clamp(vec.dot(-unit_dir, normal), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = ratio * sin_theta > 1.0
    choose_reflect = cannot_refract | (_schlick(cos_theta, ratio)
                                       > draws.u_refl)
    diel_dir = vec.where(choose_reflect, refl,
                         vec.refract(unit_dir, normal, ratio))

    is_metal = kind == METAL
    direction = vec.where(is_metal, metal_dir, lam_dir)
    direction = vec.where(kind == DIELECTRIC, diel_dir, direction)
    direction = vec.where(kind == ISOTROPIC, draws.iso, direction)
    ok = torch.where(is_metal, metal_ok, True) & (kind != DIFFUSE_LIGHT)
    return direction.detach(), ok


def scatter(scene: Scene, params: dict, generator: Optional[torch.Generator],
            in_dir: torch.Tensor, p: torch.Tensor, normal: torch.Tensor,
            front_face: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            mat_id: torch.Tensor,
            draws: Optional[ScatterDraws] = None) -> ScatterResult:
    """`material::scatter` + `emitted` (`material.h:16-138`): the sampled
    direction (detached) and the differentiable shading.  The draws come
    from `generator`, or are given (`draws`), e.g. the JAX package's own."""
    if draws is None:
        draws = draw_scatter(generator, in_dir.shape[0])
    direction, ok = scatter_direction(scene, draws, in_dir, normal,
                                      front_face, mat_id)
    attenuation, emitted = shade(scene, params, mat_id, u, v, p)
    return ScatterResult(direction, attenuation, emitted, ok)


def _schlick(cosine: torch.Tensor, ref_idx: torch.Tensor) -> torch.Tensor:
    """Schlick's reflectance (reference `material.h:97-103`)."""
    sqrt_r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = sqrt_r0 * sqrt_r0
    return r0 + (1.0 - r0) * torch.pow(torch.clamp(1.0 - cosine, min=0.0),
                                       5.0)
