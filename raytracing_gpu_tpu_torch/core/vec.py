"""Vector math on trailing-dimension-3 float32 tensors.

Counterpart of `raytracing_gpu_tpu/core/vec.py` without the
`table_gather` custom VJP: what the camera, the scene builder, the scatter
and the wavefront use.  The sums are written out term by term so that they
round in the same order as the JAX package.
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis (reference `vec3.h:124-128`)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        (a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0), dim=-1
    )


def unit(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Normalize over the trailing axis (reference `unit_vector`, `vec3.h:113`);
    the `eps` floor keeps zero vectors finite."""
    length = torch.sqrt(a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]
                        + a[..., 2] * a[..., 2])
    return a * torch.reciprocal(torch.clamp(length, min=eps))[..., None]


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis (reference `vec3.h:118-122`)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def near_zero(a: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """True where every component is tiny (reference `vec3.h:84-88`)."""
    return (a.abs() < eps).all(dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection about the normal n (reference `vec3.h:147-150`)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: torch.Tensor, n: torch.Tensor,
            etai_over_etat: torch.Tensor) -> torch.Tensor:
    """Snell refraction of the unit direction uv (reference
    `vec3.h:152-158`); a totally reflected lane gives garbage that the
    caller selects away."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    k = torch.clamp(1.0 - dot(r_out_perp, r_out_perp), min=0.0)
    return r_out_perp - torch.sqrt(k)[..., None] * n


def where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Select (..., 3) vectors by a (...,) mask."""
    return torch.where(mask[..., None], a, b)
