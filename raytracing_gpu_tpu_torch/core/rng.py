"""Random samplers on an explicit `torch.Generator`.

Counterpart of `raytracing_gpu_tpu/core/rng.py` (`uniform`, `unit_vector`,
`in_unit_sphere`, `in_unit_disk`): the same analytic, rejection-free
sampling rules (reference `vec3.h:7-13`, `:129-145`), drawing from a torch
generator instead of threaded JAX keys.  They do not reproduce JAX's
threefry stream, so results that depend on these draws agree with the JAX
package statistically.  The megakernel's own draws are the PCG hash in
`ops/cuda_trace.py`, bit for bit.
"""

from __future__ import annotations

import math

import torch


def uniform(generator: torch.Generator, shape=(), lo: float = 0.0,
            hi: float = 1.0, device: torch.device | str | None = None
            ) -> torch.Tensor:
    """U[lo, hi) float32 (reference `random_float`, `vec3.h:7-13`), on the
    generator's device unless `device` is given."""
    dev = generator.device if device is None else device
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=dev)
    return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u


def unit_vector(generator: torch.Generator, shape=()) -> torch.Tensor:
    """Uniform direction on the unit sphere, (*shape, 3) (reference
    `random_unit_vector`, `vec3.h:143-145`): z ~ U[-1, 1), phi ~ U[0, 2 pi)."""
    u = uniform(generator, (*shape, 2))
    z = 2.0 * u[..., 0] - 1.0
    phi = (2.0 * math.pi) * u[..., 1]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack((r * torch.cos(phi), r * torch.sin(phi), z), dim=-1)


def in_unit_sphere(generator: torch.Generator, shape=()) -> torch.Tensor:
    """Uniform point in the unit ball, (*shape, 3) (reference
    `random_in_unit_sphere`, `vec3.h:129-136`): a uniform direction times a
    cube-root radius."""
    d = unit_vector(generator, shape)
    r = uniform(generator, (*shape, 1)) ** (1.0 / 3.0)
    return d * r


def in_unit_disk(generator: torch.Generator, shape=()) -> torch.Tensor:
    """Uniform point in the unit disk, z = 0, (*shape, 3) (reference
    `random_in_unit_disk`, `vec3.h:138-141`): r = sqrt(U), theta = 2 pi U."""
    theta = uniform(generator, shape, 0.0, 2.0 * math.pi)
    r = torch.sqrt(uniform(generator, shape))
    return torch.stack((r * torch.cos(theta), r * torch.sin(theta),
                        torch.zeros_like(r)), dim=-1)
