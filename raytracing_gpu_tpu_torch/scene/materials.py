"""Material shading: (attenuation, emitted) per hit, differentiable.

Counterpart of the shading half of `raytracing_gpu_tpu/scene/materials.py`
(`shade`, `_fast_shade`).  Direction sampling is the record kernel's work
(`ops/csrc/megakernel.cu`); what is left here depends on the parameters
only through the texture colors, so gradients of an image flow into them.

The material kinds and the texture bindings are the scene's host numpy
arrays, so every per-material branch below is decided on the host, as the
JAX package decides it at trace time on a baked scene.
"""

from __future__ import annotations

import numpy as np
import torch

from .textures import PORTED, eval_texture
from .types import DIELECTRIC, DIFFUSE_LIGHT, TEX_CHECKER, Scene, host_table

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
    if not np.all(np.isin(tkind, PORTED)):
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
