"""Texture evaluation: tagged parameter table, compute-all-and-select.

Counterpart of `raytracing_gpu_tpu/scene/textures.py` for the texture kinds
the port covers: solid, checker, noise, turbulence and marble (the perlin
family on `scene/perlin.py`, the same function as the kernels').  Every
present kind is evaluated for the whole hit batch and the per-hit kind tag
selects the result.  The kind and
binding tables are the scene's host numpy arrays; the colors are torch
parameter tensors (`engine.diff.get_params`), so the result is
differentiable with respect to them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import perlin
from .types import (TEX_CHECKER, TEX_IMAGE, TEX_MARBLE, TEX_NOISE, TEX_SOLID,
                    TEX_TURB, Scene, host_table)

TEXTURE_NAMES = {TEX_SOLID: "solid", TEX_CHECKER: "checker",
                 TEX_NOISE: "noise", TEX_TURB: "turbulence",
                 TEX_MARBLE: "marble", TEX_IMAGE: "image"}
PORTED = (TEX_SOLID, TEX_CHECKER, TEX_NOISE, TEX_TURB, TEX_MARBLE)


def eval_texture(scene: Scene, params: dict, tex_id: torch.Tensor,
                 u: torch.Tensor, v: torch.Tensor,
                 p: torch.Tensor) -> torch.Tensor:
    """Texture color (N, 3) for each hit.

    tex_id: (N,) int64 or int32 indices into the scene's texture table;
    u, v: (N,); p: (N, 3); params: {"tex_c1", "tex_c2", ...} float32
    tensors.  Raises NotImplementedError when the table holds a kind that
    is not ported (image), naming it.
    """
    tx = scene.textures
    present = {int(k) for k in np.unique(tx.kind)}
    unported = sorted(present - set(PORTED))
    if unported:
        raise NotImplementedError(
            f"{TEXTURE_NAMES.get(unported[0], unported[0])} texture: "
            "not yet ported")
    dev = params["tex_c1"].device
    tex_id = tex_id.long()
    kind = host_table(tx.kind, dev)[tex_id]                # (N,)
    c1 = params["tex_c1"][tex_id]                           # (N, 3)
    c2 = params["tex_c2"][tex_id]
    scale = host_table(tx.scale, dev)[tex_id]              # (N,)

    # solid_color (reference texture.h:12-23)
    out = torch.where((kind == TEX_SOLID)[..., None], c1, 0.0)
    if TEX_CHECKER in present:
        # checker_texture: sign of the product of sines (reference
        # texture.h:26-46), with the scale param as the frequency
        sines = (torch.sin(scale * p[..., 0]) * torch.sin(scale * p[..., 1])
                 * torch.sin(scale * p[..., 2]))
        checker = torch.where((sines < 0.0)[..., None], c2, c1)
        out = torch.where((kind == TEX_CHECKER)[..., None], checker, out)
    if present & {TEX_NOISE, TEX_TURB, TEX_MARBLE}:
        # the perlin family at scale * p (reference texture.h:49-91)
        sx, sy, sz = (scale * p[..., k] for k in range(3))
        grays = {}
        if TEX_NOISE in present:
            grays[TEX_NOISE] = 0.5 * (1.0 + perlin.noise3(sx, sy, sz))
        if present & {TEX_TURB, TEX_MARBLE}:
            turb = perlin.turb3(sx, sy, sz, depth=7)
            grays[TEX_TURB] = turb
            grays[TEX_MARBLE] = 0.5 * (1.0 + torch.sin(sz + 10.0 * turb))
        for k, gray in grays.items():
            out = torch.where((kind == k)[..., None], gray[..., None], out)
    return out
