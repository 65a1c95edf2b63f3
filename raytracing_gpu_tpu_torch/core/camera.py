"""Thin-lens camera with defocus and motion blur.

Counterpart of `raytracing_gpu_tpu/core/camera.py`: the camera is a dataclass
of float32 tensors holding the precomputed basis (reference
`camera.h:18-47`), and `get_rays` makes a whole batch of rays at once.  The
megakernel does not call `get_rays`: it takes the basis as constants and
makes its rays itself (`ops/cuda_trace.py`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import vec


@dataclasses.dataclass(frozen=True)
class Camera:
    origin: torch.Tensor             # (3,)
    lower_left_corner: torch.Tensor  # (3,)
    horizontal: torch.Tensor         # (3,)
    vertical: torch.Tensor           # (3,)
    u: torch.Tensor                  # (3,) right basis vector
    v: torch.Tensor                  # (3,) up basis vector
    w: torch.Tensor                  # (3,) back basis vector
    lens_radius: torch.Tensor        # ()
    time0: torch.Tensor              # () shutter open
    time1: torch.Tensor              # () shutter close

    @staticmethod
    def make(
        lookfrom,
        lookat,
        vup=(0.0, 1.0, 0.0),
        vfov: float = 40.0,
        aspect_ratio: float = 16.0 / 9.0,
        aperture: float = 0.0,
        focus_dist: float = 10.0,
        time0: float = 0.0,
        time1: float = 1.0,
        device: torch.device | str = "cpu",
    ) -> "Camera":
        """Build the viewport basis in float32, as reference `camera.h:18-47`
        and the JAX package's `Camera.make` do."""
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        lookfrom, lookat, vup = f32(lookfrom), f32(lookat), f32(vup)

        theta = math.radians(vfov)
        h = math.tan(theta / 2.0)
        viewport_height = 2.0 * h
        viewport_width = aspect_ratio * viewport_height

        w = vec.unit(lookfrom - lookat)
        u = vec.unit(vec.cross(vup, w))
        v = vec.cross(w, u)

        origin = lookfrom
        horizontal = focus_dist * viewport_width * u
        vertical = focus_dist * viewport_height * v
        lower_left_corner = origin - horizontal / 2.0 - vertical / 2.0 - focus_dist * w

        return Camera(
            origin=origin,
            lower_left_corner=lower_left_corner,
            horizontal=horizontal,
            vertical=vertical,
            u=u,
            v=v,
            w=w,
            lens_radius=f32(aperture / 2.0),
            time0=f32(time0),
            time1=f32(time1),
        )

    def to(self, device: torch.device | str) -> "Camera":
        """The same camera with its tensors on `device`."""
        return Camera(**{f.name: getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)})

    def get_rays(self, generator: torch.Generator, s: torch.Tensor,
                 t: torch.Tensor):
        """Batched `get_ray` (reference `camera.h:49-58`).

        s, t: (N,) viewport coordinates in [0, 1], on the camera's device;
        `generator` lives on the same device.  Returns (origins (N, 3),
        directions (N, 3), times (N,)): the lens-disk offset gives defocus
        blur, the random time in [time0, time1] motion blur.
        """
        shape, dev = s.shape, s.device
        theta = (2.0 * math.pi) * torch.rand(shape, generator=generator,
                                             device=dev)
        r = torch.sqrt(torch.rand(shape, generator=generator, device=dev))
        rd = self.lens_radius * torch.stack(
            (r * torch.cos(theta), r * torch.sin(theta)), dim=-1)
        offset = self.u * rd[..., 0:1] + self.v * rd[..., 1:2]
        origin = self.origin + offset
        direction = (
            self.lower_left_corner
            + s[..., None] * self.horizontal
            + t[..., None] * self.vertical
            - origin
        )
        time = self.time0 + (self.time1 - self.time0) * torch.rand(
            shape, generator=generator, device=dev)
        return origin, direction, time
