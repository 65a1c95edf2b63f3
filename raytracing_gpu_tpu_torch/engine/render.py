"""Render loop: sample chunks of kernel waves.

Counterpart of `raytracing_gpu_tpu/engine/render.py` for its megakernel,
regen and wavefront routes, chosen as `compile_renderer` chooses them
there.  A chunk is `spp_per_chunk` samples of every pixel.  On the
megakernel route each sample is split into waves of `ray_batch` pixels, and
each (sample, wave) is one kernel launch whose seed is scalar arithmetic on
the chunk's base seed (`ops.cuda_trace.wave_seed`); the regen and wavefront
routes (`engine/wavefront.py`) seed their generators with the base.  Chunk
sums accumulate in float32 on the device; `render_linear` draws each
chunk's base from a `torch.Generator` seeded with `settings.seed`.

Not ported yet: the XLA and record-walk engines, and checkpoint/resume.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Callable, Optional

import numpy as np
import torch

from ..core.camera import Camera
from ..core.config import RenderSettings
from ..ops import cuda_trace
from ..scene.types import Scene
from ..utils.profiling import logger, synchronize
from . import film


def _grid_geometry(settings: RenderSettings):
    h, w = settings.image_height, settings.image_width
    npix = h * w
    b = min(settings.ray_batch, _ceil_to(npix, 8))
    npix_pad = _ceil_to(npix, b)
    return h, w, npix, npix_pad, b, npix_pad // b


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def route(tracer: cuda_trace.Tracer, settings: RenderSettings) -> str:
    """The engine `compile_renderer` takes, as the JAX package routes
    `engine="pallas"` (`engine/render.py:117-199`) among the ported ones.
    A scene without media goes to a wavefront when the JAX bake would
    stream its triangle table (`SceneBake.jax_tri_stream`: the 100k-triangle
    meshes) or when it has a sphere BVH and depth >= 8 (the megakernel's
    unsorted waves straggle at depth on the deep BVH): to "regen" at >= 16
    spp per chunk, else to the bounce-synchronous "wavefront" for the
    meshes.  Everything else goes to "megakernel".  The JAX package's clause
    for image-textured scenes waits for image textures."""
    mesh = tracer.bake.jax_tri_stream
    deep_sphere_bvh = (len(tracer.bake.sph_hit_nodes) > 0
                       and settings.max_depth >= 8)
    if (mesh or deep_sphere_bvh) and tracer.supports_hit:
        if settings.spp_per_chunk >= 16:
            return "regen"
        if mesh:
            return "wavefront"
    return "megakernel"


def compile_renderer(scene: Scene, camera: Camera, settings: RenderSettings,
                     device: torch.device | str = "cuda"
                     ) -> Callable[[int], torch.Tensor]:
    """Scene-specialized forward renderer: int32 base seed -> (npix_pad, 3)
    float32 radiance sums on `device` over `spp_per_chunk` samples; its
    `engine_name` is the route (`route`).

    The megakernel route (`engine/render.py:172-199`) launches once per
    (sample, wave), with russian roulette from bounce `settings.rr_start`
    when it is > 0; the regen and wavefront routes are
    `wavefront.compile_regen_renderer` and
    `wavefront.compile_wavefront_renderer`.
    Raises NotImplementedError for a scene outside the ported feature set.
    """
    device = torch.device(device)
    tracer = cuda_trace.Tracer(scene, device)  # raises for unported scenes
    engine = route(tracer, settings)
    if engine != "megakernel":
        from . import wavefront

        compile_wave = (wavefront.compile_regen_renderer if engine == "regen"
                        else wavefront.compile_wavefront_renderer)
        return compile_wave(scene, camera, settings, tracer=tracer,
                            device=device)
    h, w, _npix, npix_pad, b, nb = _grid_geometry(settings)
    trace = tracer.bind(camera, h, w, settings.max_depth, settings.t_min,
                        settings.rr_start)

    def chunk(base: int) -> torch.Tensor:
        sums = torch.zeros((npix_pad, 3), dtype=torch.float32, device=device)
        for s in range(settings.spp_per_chunk):
            for bid in range(nb):
                sums[bid * b:(bid + 1) * b] += trace(
                    bid * b, b, cuda_trace.wave_seed(base, s, bid))
        return sums

    chunk.engine_name = "megakernel"
    return chunk


def render_linear(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    seed: Optional[int] = None,
    progress: Optional[Callable[[int, int, float], None]] = None,
    device: torch.device | str = "cuda",
    timer=None,
) -> np.ndarray:
    """Full render -> (H, W, 3) mean linear radiance (host numpy).

    timer: optional `utils.profiling.PhaseTimer` collecting the build
    (scene bake) and trace (chunks, synchronized) phases.
    """
    phase = timer.phase if timer is not None else (lambda _name: nullcontext())
    device = torch.device(device)
    h, w, npix, npix_pad, _, _ = _grid_geometry(settings)
    gen = torch.Generator().manual_seed(settings.seed if seed is None else seed)
    with phase("build"):
        chunk = compile_renderer(scene, camera, settings, device)
    logger.info("render engine: %s on %s", chunk.engine_name, device)
    sums = torch.zeros((npix_pad, 3), dtype=torch.float32, device=device)
    for c in range(settings.num_chunks):
        t0 = time.perf_counter()
        with phase("trace"):
            sums += chunk(cuda_trace.chunk_seed(gen))
            synchronize(device)
        if progress is not None:
            progress(c + 1, settings.num_chunks, time.perf_counter() - t0)
    out = sums[:npix].cpu().numpy()
    return (out / float(settings.rays_per_pixel)).reshape(h, w, 3)


def render(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    seed: Optional[int] = None,
    progress: Optional[Callable[[int, int, float], None]] = None,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Full render -> (H, W, 3) gamma-2 image in [0, 1) (reference `draw`,
    `render.h:118-174`)."""
    linear = render_linear(scene, camera, settings, seed=seed,
                           progress=progress, device=device)
    return film.finalize(linear * settings.rays_per_pixel,
                         settings.rays_per_pixel)
