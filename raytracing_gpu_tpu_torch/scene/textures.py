"""Texture evaluation: tagged parameter table, compute-all-and-select.

Counterpart of `raytracing_gpu_tpu/scene/textures.py`: solid, checker,
noise, turbulence and marble (the perlin family on `scene/perlin.py`, the
same function as the kernels'), and image textures, a nearest-texel lookup
in the flat atlas (`_eval_image`).  Every present kind is evaluated for the
whole hit batch and the per-hit kind tag selects the result.  The kind and
binding tables, and the atlas's offsets and sizes, are the scene's host
numpy arrays; the colors and the atlas's texels are torch parameter tensors
(`engine.diff.get_params`), so the result is differentiable with respect
to them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import perlin
from .types import (TEX_CHECKER, TEX_IMAGE, TEX_MARBLE, TEX_NOISE, TEX_SOLID,
                    TEX_TURB, Scene, host_table)

_CYAN = (0.0, 1.0, 1.0)  # an image slot with no image bound (texture.h:146)


def eval_texture(scene: Scene, params: dict, tex_id: torch.Tensor,
                 u: torch.Tensor, v: torch.Tensor,
                 p: torch.Tensor) -> torch.Tensor:
    """Texture color (N, 3) for each hit.

    tex_id: (N,) int64 or int32 indices into the scene's texture table;
    u, v: (N,); p: (N, 3); params: {"tex_c1", "tex_c2", "atlas_data"}
    float32 tensors.
    """
    tx = scene.textures
    present = {int(k) for k in np.unique(tx.kind)}
    dev = params["tex_c1"].device
    tex_id = tex_id.long()
    kind = host_table(tx.kind, dev)[tex_id]                # (N,)
    # gathers whose backward is an atomic scatter-add, as the atlas's (see
    # `_eval_image`): a scene has few textures, so a batch's indices repeat
    # in long runs.  Only scenes with a perlin or image texture come here;
    # solid and checker ones take `materials._fast_shade`.
    c1 = params["tex_c1"].index_select(0, tex_id)           # (N, 3)
    c2 = params["tex_c2"].index_select(0, tex_id)
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
    if TEX_IMAGE in present:
        image_id = host_table(tx.image_id, dev)[tex_id]
        image = _eval_image(scene, params["atlas_data"], image_id, u, v)
        out = torch.where((kind == TEX_IMAGE)[..., None], image, out)
    return out


def _eval_image(scene: Scene, atlas_data: torch.Tensor,
                image_id: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """Nearest-texel atlas lookup (`textures._eval_image`, reference
    `image_texture::value`, `texture.h:144-163`): uv clamped to [0, 1], v
    flipped, the texel column `min(int(u * w), w - 1)` (truncated, as
    `astype(int32)`) and likewise the row, then three flat gathers at
    `(offset + j * w + i) * 3 + c`; cyan where `image_id < 0`.  Plain
    gathers (`index_select`): autograd's scatter-add (`index_add_`) gives
    `atlas_data` its gradient, as the JAX package's VJP of the same
    gathers does.  Not `atlas_data[base]`: on CUDA the backward pass of
    advanced indexing sorts the indices and walks each run of equal ones
    in one thread, and every plane entry that no hit wrote (uv 0) reads
    the same texel, so one run holds most of a wave's entries.  The
    atomic scatter-add's order of additions varies from run to run, so on
    the card the texture gradients of a scene that reaches this shade
    (an image or perlin texture) are not bit-for-bit reproducible."""
    at = scene.atlas
    dev = atlas_data.device
    image_id = image_id.long()
    w = host_table(at.width, dev)[image_id]       # (N,) int32
    h = host_table(at.height, dev)[image_id]
    off = host_table(at.offset, dev)[image_id]
    uu = torch.clamp(u, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v, 0.0, 1.0)
    i = torch.minimum((uu * w.to(torch.float32)).to(torch.int32), w - 1)
    j = torch.minimum((vv * h.to(torch.float32)).to(torch.int32), h - 1)
    base = (off.long() + j.long() * w.long() + i.long()) * 3
    # as XLA's gather clamps its start index: a NaN uv (a plane entry that
    # no hit wrote, which the shade masks) still reads a texel
    base = torch.clamp(base, 0, atlas_data.shape[0] - 3)
    rgb = torch.stack([atlas_data.index_select(0, base + c)
                       for c in range(3)], dim=-1)
    cyan = torch.tensor(_CYAN, dtype=rgb.dtype, device=dev)
    return torch.where((image_id >= 0)[..., None], rgb, cyan)
