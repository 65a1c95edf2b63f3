"""Sharded rendering over an (sp, dp) mesh of ranks (counterpart of
`raytracing_gpu_tpu/parallel/render.py`).

Every rank traces the pixel span its dp coordinate owns for the samples
its sp coordinate owns; the partial sums are summed over the sp group and
the spans gathered over the dp group (`parallel.mesh.Mesh`).  Each wave is
seeded by its global sample and wave index (`cuda_trace.wave_seed(base,
s, bid)`, as `render.chunk_sums` seeds it), so a sharded chunk equals the
port's unsharded chunk: bit for bit under dp alone, to float summation
order under sp.  The regen route runs one persistent wave a rank, with a
stream of its own, so it agrees with the unsharded regen chunk
statistically, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.camera import Camera
from ..core.config import RenderSettings
from ..engine import render as render_mod
from ..ops import cuda_trace
from ..scene.types import Scene
from .mesh import DP_AXIS, SP_AXIS, Mesh

REGEN_SALT = 0x5A11   # a rank's regen stream: (base, REGEN_SALT + sp, dp)


def render_chunk_sharded(scene: Scene, camera: Camera,
                         settings: RenderSettings, base: int, mesh: Mesh,
                         trace_fn: Optional[Callable] = None,
                         device: torch.device | str = "cuda"
                         ) -> torch.Tensor:
    """One sample chunk on the mesh: this rank's dp span, (local_npix, 3)
    float32 sums over every sample of the chunk (summed over the sp group).

    Wave (s_g, bid_g) = (sp * spp_local + s, dp * nb_local + bid) draws its
    rays with `render.wave_rays(..., wave_seed(base, s_g, bid_g))` and
    traces them with `trace_fn(scene, o, d, tm, seed) -> (b, 3)`, the xla
    route's (`render.xla_trace_fn`) by default; a wave that the dp padding
    adds past the image is not traced (its rows lie past the image).
    Raises ValueError when n_sp does not divide `spp_per_chunk`."""
    device = torch.device(device)
    b, nb, _npix_pad, local_npix, nb_local, spp_local = (
        render_mod.shard_geometry(settings, mesh))
    if trace_fn is None:
        trace_fn = render_mod.xla_trace_fn(scene, settings, device)
    cam = camera.to(device)
    sums = torch.zeros((local_npix, 3), dtype=torch.float32, device=device)
    with torch.no_grad():
        for s in range(spp_local):
            s_g = mesh.sp * spp_local + s
            for bid in range(nb_local):
                bid_g = mesh.dp * nb_local + bid
                if bid_g >= nb:
                    break
                o, d, tm, seed = render_mod.wave_rays(
                    cam, settings, bid_g * b, b,
                    cuda_trace.wave_seed(base, s_g, bid_g), device)
                sums[bid * b:(bid + 1) * b] += trace_fn(scene, o, d, tm, seed)
        return mesh.sum_sp(sums)


def compile_sharded_renderer(scene: Scene, camera: Camera,
                             settings: RenderSettings, mesh: Mesh,
                             engine: str = "auto",
                             device: torch.device | str = "cuda",
                             tracer: Optional[cuda_trace.Tracer] = None
                             ) -> Callable[[int], torch.Tensor]:
    """Scene-specialized sharded chunk: base -> this rank's dp span of the
    chunk's sums, summed over the sp group; `engine_name` is the route.
    The kernel routes take `tracer`, a `cuda_trace.Tracer` of `scene` on
    `device`, or bake their own.

    The routes and their predicates are the JAX package's
    (`parallel/render.py:123-222`), which are `render.route`'s with the
    rank's sample share in place of the chunk's:

    - "regen": each rank runs `wavefront.compile_regen_renderer`'s body
      over its span of ceil(npix / n_dp) pixels at spp_local samples, its
      stream seeded with `wave_seed(base, REGEN_SALT + sp, dp)`;
    - "wavefront": `render_chunk_sharded` over `wavefront.make_trace_wave`;
    - "megakernel": `render_chunk_sharded` over the forward kernel on ray
      planes (`Tracer.bind_trace_rays`, kernel 1c), as the JAX package
      calls `PallasTracer.__call__` here;
    - "record-walk": `render_chunk_sharded` over the record kernel on ray
      planes and the torch shade (`render.record_walk_trace_fn`), which
      ignores `rr_start` with a warning;
    - "xla": `render_chunk_sharded` over `integrator.trace`.

    "pallas" raises NotImplementedError for a scene that no kernel covers;
    "auto" takes "xla" there (`render._xla_wanted`)."""
    device = torch.device(device)
    spp_local = render_mod.shard_geometry(settings, mesh)[5]
    if render_mod._xla_wanted(scene, engine, render_mod.ENGINES):
        engine_name, trace_fn = "xla", render_mod.xla_trace_fn(
            scene, settings, device)
    else:
        if tracer is None:
            tracer = cuda_trace.Tracer(scene, device)  # raises for unported
        engine_name = render_mod.route(
            tracer, settings.with_(spp_per_chunk=spp_local))
        if engine_name == "regen":
            return _regen_chunk(scene, camera, settings, mesh, tracer,
                                device)
        if engine_name == "wavefront":
            from ..engine.wavefront import make_trace_wave

            trace_wave = make_trace_wave(scene, tracer, settings.max_depth,
                                         settings.t_min, settings.rr_start,
                                         device)

            def trace_fn(_scene, o, d, tm, seed):
                gen = torch.Generator(device=device).manual_seed(seed)
                return trace_wave(o, d, tm, gen)[0]
        elif engine_name == "megakernel":
            launch = tracer.bind_trace_rays(settings.max_depth,
                                            settings.t_min,
                                            settings.rr_start)

            def trace_fn(_scene, o, d, tm, seed):
                return launch(o, d, tm, seed)
        else:
            trace_fn = render_mod.record_walk_trace_fn(scene, settings,
                                                       tracer, device)

    def chunk(base: int) -> torch.Tensor:
        return render_chunk_sharded(scene, camera, settings, int(base), mesh,
                                    trace_fn, device)

    chunk.engine_name = engine_name
    return chunk


def _regen_chunk(scene: Scene, camera: Camera, settings: RenderSettings,
                 mesh: Mesh, tracer: cuda_trace.Tracer,
                 device: torch.device) -> Callable[[int], torch.Tensor]:
    """The regen route (`parallel/render.py:147-188`): this rank's span of
    ceil(npix / n_dp) pixels from its own persistent wave, summed over the
    sp group."""
    from ..engine.wavefront import compile_regen_renderer

    npix = settings.num_pixels
    local_npix = -(-npix // mesh.shape[DP_AXIS])
    spp_local = settings.spp_per_chunk // mesh.shape[SP_AXIS]
    body = compile_regen_renderer(scene, camera, settings, tracer=tracer,
                                  device=device,
                                  _local=(local_npix, spp_local))

    def chunk(base: int) -> torch.Tensor:
        seed = cuda_trace.wave_seed(base, REGEN_SALT + mesh.sp, mesh.dp)
        with torch.no_grad():
            return mesh.sum_sp(body(seed, mesh.dp * local_npix)[:local_npix])

    chunk.engine_name = "regen"
    return chunk


def make_sharded_chunk_fn(mesh: Mesh, scene: Optional[Scene] = None,
                          camera: Optional[Camera] = None,
                          settings: Optional[RenderSettings] = None,
                          engine: str = "auto",
                          device: torch.device | str = "cuda"
                          ) -> Callable[..., torch.Tensor]:
    """`chunk(scene, camera, settings, base) -> (npix_pad, 3)` sums on
    every rank, for `render.render_linear(chunk_fn=...)` (the CLI's
    `--sharded`): the spans gathered over the dp group, cut to the image
    and padded with zero rows to `render._grid_geometry`'s npix_pad
    (`parallel/render.py:233-270`).

    With (scene, camera, settings) the chunk is `compile_sharded_renderer`'s
    (its route is `engine_name`); without them it is the generic
    `render_chunk_sharded` on the xla route, built for each call."""
    device = torch.device(device)
    compiled = None
    if scene is not None:
        compiled = compile_sharded_renderer(scene, camera, settings, mesh,
                                            engine, device)

    def chunk(scene_: Scene, camera_: Camera, settings_: RenderSettings,
              base: int) -> torch.Tensor:
        if compiled is not None:
            span = compiled(base)
        else:
            span = render_chunk_sharded(scene_, camera_, settings_, base,
                                        mesh, device=device)
        out = mesh.gather_dp(span)
        _h, _w, npix, npix_pad, _b, _nb = render_mod._grid_geometry(
            settings_)
        full = torch.zeros((npix_pad, 3), dtype=torch.float32,
                           device=out.device)
        full[:npix] = out[:npix]
        return full

    chunk.engine_name = compiled.engine_name if compiled is not None else "xla"
    return chunk
