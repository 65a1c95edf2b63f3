"""Render configuration (counterpart of `raytracing_gpu_tpu/core/config.py`).

The same frozen dataclass, fields, defaults and derived properties as the JAX
package, so one settings object reads the same in both packages.  Here the
fields shape kernel launches (wave size, depth) instead of compiled XLA
programs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    image_width: int = 1200                  # reference `render.h:22`
    aspect_ratio: float = 16.0 / 9.0         # reference `render.h:24`
    spp_per_chunk: int = 100                 # reference samples_per_pixel_per_fb `render.h:26`
    num_chunks: int = 10                     # reference no_fb `render.h:37`
    max_depth: int = 50                      # reference `render.h:27`
    ray_batch: int = 65536                   # rays per kernel launch (one wave)
    t_min: float = 0.001                     # reference `render.h:62`
    seed: int = 1984                         # reference seed `render.h:91`
    rr_start: int = 0                        # russian roulette from this bounce (0 = off)

    @property
    def image_height(self) -> int:
        # reference `calc_height` (`render.h:30-33`)
        return int(self.image_width / self.aspect_ratio)

    @property
    def num_pixels(self) -> int:
        return self.image_width * self.image_height

    @property
    def rays_per_pixel(self) -> int:
        # reference `calc_rays` (`render.h:35-38`)
        return self.spp_per_chunk * self.num_chunks

    def with_(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)
