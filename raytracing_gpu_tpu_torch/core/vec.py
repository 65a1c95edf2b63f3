"""Vector math on trailing-dimension-3 float32 tensors.

Counterpart of `raytracing_gpu_tpu/core/vec.py`, reduced to what the camera
and the scene builder use.  The sums are written out term by term so that
they round in the same order as the JAX package.
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
