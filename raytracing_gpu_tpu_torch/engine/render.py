"""Render loop: sample chunks of kernel waves.

Counterpart of `raytracing_gpu_tpu/engine/render.py`: `compile_renderer`
with its megakernel, regen, wavefront, record-walk and xla routes, chosen
as it chooses them there, and the differentiable `compile_param_renderer`
with its record-walk, wavefront-record and xla routes.  The "xla" route is
the pure-torch engine (`integrator.trace`, `trace_diff`): it serves the
scenes no kernel covers (`cuda_trace.unported_feature`), or any scene on
request.  A chunk is `spp_per_chunk`
samples of every pixel, each sample split into waves of `ray_batch`
pixels, and wave (s, bid) seeded with scalar arithmetic on the chunk's base
seed (`ops.cuda_trace.wave_seed`).  On the megakernel route the whole chunk
is one kernel launch (`Tracer.bind_chunk`); the regen and wavefront routes
(`engine/wavefront.py`) seed their generators with the base.
`chunk_sums` draws each (sample, wave)'s camera rays in torch, from a
generator seeded with the wave's seed, for the routes that take ray planes.
Chunk sums accumulate in float32 on the device; `render_linear` draws each
chunk's base from a `torch.Generator` seeded with `settings.seed`, and with
a checkpoint directory saves the sums after every chunk and resumes from
the last one saved (`utils/checkpoint.py`).
"""

from __future__ import annotations

import time
import warnings
from contextlib import nullcontext
from typing import Callable, Optional

import numpy as np
import torch

from ..core.camera import Camera
from ..core.config import RenderSettings
from ..ops import cuda_trace
from ..parallel.mesh import DP_AXIS, SP_AXIS
from ..scene.types import Scene
from ..utils.profiling import logger, nan_debugging, synchronize
from . import film


def _grid_geometry(settings: RenderSettings):
    h, w = settings.image_height, settings.image_width
    npix = h * w
    b = min(settings.ray_batch, _ceil_to(npix, 8))
    npix_pad = _ceil_to(npix, b)
    return h, w, npix, npix_pad, b, npix_pad // b


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_geometry(settings: RenderSettings, mesh):
    """A chunk's waves on an (sp, dp) `parallel.mesh.Mesh`
    (`parallel/render.py:47-59`): (b, nb, npix_pad, local_npix, nb_local,
    spp_local).  Waves of b pixels, nb of them over the image
    (`_grid_geometry`); the pixel rows padded to npix_pad = a multiple of
    b * n_dp, split into dp spans of local_npix rows, nb_local waves each;
    spp_local samples a rank.  Raises ValueError when n_sp does not divide
    `spp_per_chunk`, or on a rank outside the mesh."""
    if not mesh.member:
        raise ValueError("this rank is not in the mesh")
    n_sp, n_dp = mesh.shape[SP_AXIS], mesh.shape[DP_AXIS]
    if settings.spp_per_chunk % n_sp:
        raise ValueError(f"spp_per_chunk={settings.spp_per_chunk} not "
                         f"divisible by sp axis size {n_sp}")
    _h, _w, npix, _npix_pad, b, nb = _grid_geometry(settings)
    npix_pad = _ceil_to(npix, b * n_dp)
    local_npix = npix_pad // n_dp
    return (b, nb, npix_pad, local_npix, local_npix // b,
            settings.spp_per_chunk // n_sp)


def wave_rays(camera: Camera, settings: RenderSettings, pix_base: int,
              n: int, seed: int, device: torch.device) -> tuple:
    """The camera rays of one (sample, wave) and the kernel's int32 seed:
    `render.chunk_sums`'s schedule with a torch generator for the JAX key.
    A generator on `device` seeded with `seed` (`wave_seed(base, s, bid)`)
    draws the pixel jitter, then the lens and shutter time
    (`Camera.get_rays`), then the seed.  Returns (o (n, 3), d (n, 3),
    tm (n,), seed): rays of pixels [pix_base, pix_base + n), past the image
    clamped to its last row and column."""
    h, w = settings.image_height, settings.image_width
    gen = torch.Generator(device=device).manual_seed(int(seed) & 0xFFFFFFFF)
    flat = torch.arange(pix_base, pix_base + n, dtype=torch.int64,
                        device=device)
    rows = torch.clamp(torch.div(flat, w, rounding_mode="floor"), max=h - 1)
    cols = torch.clamp(flat % w, max=w - 1)
    jit2 = torch.rand((n, 2), generator=gen, device=device)
    su = (cols.to(torch.float32) + jit2[:, 0]) * (1.0 / max(w - 1, 1))
    sv = ((h - 1 - rows).to(torch.float32) + jit2[:, 1]) * (
        1.0 / max(h - 1, 1))
    o, d, tm = camera.get_rays(gen, su, sv)
    kseed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                              device=device))
    return o.contiguous(), d.contiguous(), tm.contiguous(), kseed


def chunk_sums(scene: Scene, camera: Camera, settings: RenderSettings,
               base: int, trace_fn: Callable, device: torch.device | str
               ) -> torch.Tensor:
    """One sample chunk over camera rays drawn in torch
    (`render.chunk_sums`, :50-89): (npix_pad, 3) float32 radiance sums over
    `spp_per_chunk` samples.  Wave (s, bid) draws its rays by `wave_rays`
    with seed `wave_seed(base, s, bid)` and traces them with
    `trace_fn(scene, o, d, tm, seed) -> (b, 3)`."""
    device = torch.device(device)
    cam = camera.to(device)
    _h, _w, _npix, npix_pad, b, nb = _grid_geometry(settings)
    sums = torch.zeros((npix_pad, 3), dtype=torch.float32, device=device)
    for s in range(settings.spp_per_chunk):
        for bid in range(nb):
            o, d, tm, seed = wave_rays(cam, settings, bid * b, b,
                                       cuda_trace.wave_seed(base, s, bid),
                                       device)
            sums[bid * b:(bid + 1) * b] += trace_fn(scene, o, d, tm, seed)
    return sums


def route(tracer: cuda_trace.Tracer, settings: RenderSettings) -> str:
    """The engine `compile_renderer` takes, as the JAX package routes
    `engine="pallas"` (`engine/render.py:117-228`).  A scene without media
    goes to a wavefront when the JAX bake would stream its triangle table
    (`SceneBake.jax_tri_stream`: the 100k-triangle meshes), when it has
    image textures and russian roulette (the record walk carries no
    throughput to roulette), when it has a sphere BVH and depth >= 8, or
    when it has image textures and depth >= 24 (the unsorted waves of the
    megakernel and of the record walk straggle at depth): to "regen" at
    >= 16 spp per chunk, else to the bounce-synchronous "wavefront" but for
    the sphere BVH alone.  Otherwise a scene the forward kernel takes goes
    to "megakernel", and an image-textured one to "record-walk": the record
    kernel on ray planes and the torch shade."""
    image = not tracer.supports_forward
    want_wavefront = tracer.bake.jax_tri_stream or (
        settings.rr_start > 0 and image)
    deep_sphere_bvh = (len(tracer.bake.sph_hit_nodes) > 0
                       and settings.max_depth >= 8)
    deep_record = image and settings.max_depth >= 24
    if (want_wavefront or deep_sphere_bvh or deep_record) \
            and tracer.supports_hit:
        if settings.spp_per_chunk >= 16:
            return "regen"
        if want_wavefront or deep_record:
            return "wavefront"
    return "record-walk" if image else "megakernel"


ENGINES = ("auto", "pallas", "xla")


def _xla_wanted(scene: Scene, engine: str, engines: tuple) -> bool:
    """Whether `engine` takes the xla route: asked for by name, or "auto"
    on a scene that no kernel covers (where the JAX package's
    `supports_scene` is false)."""
    if engine not in engines:
        raise ValueError(f"engine {engine!r}: use one of {engines}")
    return engine == "xla" or (engine == "auto"
                               and cuda_trace.unported_feature(scene)
                               is not None)


def compile_renderer(scene: Scene, camera: Camera, settings: RenderSettings,
                     device: torch.device | str = "cuda",
                     engine: str = "auto"
                     ) -> Callable[[int], torch.Tensor]:
    """Scene-specialized forward renderer: int32 base seed -> (npix_pad, 3)
    float32 radiance sums on `device` over `spp_per_chunk` samples; its
    `engine_name` is the route (`route`, or "xla").

    engine: "pallas" takes the hand-written kernels (the JAX package's name
    for its kernels) and raises NotImplementedError for a scene they do not
    cover; "xla" the pure-torch engine (`integrator.trace`, `chunk_sums`
    over it, russian roulette from `settings.rr_start`); "auto" takes
    "xla" exactly where `cuda_trace.unported_feature(scene)` names a
    feature, else the kernels.

    The megakernel route (`engine/render.py:172-199`) launches the forward
    kernel once a chunk (`Tracer.bind_chunk`: the (sample, wave) sums added
    in order, bit for bit), with russian roulette from bounce
    `settings.rr_start` when it is > 0; the regen and wavefront routes are
    `wavefront.compile_regen_renderer` and
    `wavefront.compile_wavefront_renderer`; the record-walk route
    (`:200-228`) is `chunk_sums` over `Tracer.walk` (kernel 1c with the
    record kernel's uv planes) and `integrator.shade_radiance`, one launch
    per (sample, wave), and ignores `rr_start` with a warning, as the JAX
    package does.
    """
    device = torch.device(device)
    if _xla_wanted(scene, engine, ENGINES):
        return _xla_renderer(scene, camera, settings, device)
    tracer = cuda_trace.Tracer(scene, device)  # raises for unported scenes
    engine = route(tracer, settings)
    if engine == "record-walk":
        return _record_walk_renderer(scene, camera, settings, tracer, device)
    if engine != "megakernel":
        from . import wavefront

        compile_wave = (wavefront.compile_regen_renderer if engine == "regen"
                        else wavefront.compile_wavefront_renderer)
        return compile_wave(scene, camera, settings, tracer=tracer,
                            device=device)
    h, w, _, _, b, _ = _grid_geometry(settings)
    chunk = tracer.bind_chunk(camera, h, w, settings.max_depth,
                              settings.t_min, settings.rr_start, b,
                              settings.spp_per_chunk)
    chunk.engine_name = "megakernel"
    return chunk


def xla_trace_fn(scene: Scene, settings: RenderSettings,
                 device: torch.device) -> Callable:
    """The xla route's `trace_fn(scene, o, d, tm, seed) -> (n, 3)`:
    `integrator.trace` with the scene's parameters, drawing from a
    generator seeded with the wave's seed."""
    from .diff import get_params
    from .intersect import geometry
    from .integrator import trace

    params = get_params(scene, device)
    geom = geometry(scene, device)

    def trace_fn(scene_, o, d, tm, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return trace(scene_, o, d, tm, gen, max_depth=settings.max_depth,
                     t_min=settings.t_min, rr_start=settings.rr_start,
                     params=params, geom=geom)

    return trace_fn


def _xla_renderer(scene: Scene, camera: Camera, settings: RenderSettings,
                  device: torch.device) -> Callable[[int], torch.Tensor]:
    """The xla route's chunk (`engine/render.py:222-228`): `chunk_sums`
    over `integrator.trace`, each wave's draws from a generator seeded with
    the wave's seed."""
    trace_fn = xla_trace_fn(scene, settings, device)

    def chunk(base: int) -> torch.Tensor:
        with torch.no_grad():
            return chunk_sums(scene, camera, settings, int(base), trace_fn,
                              device)

    chunk.engine_name = "xla"
    return chunk


def record_walk_trace_fn(scene: Scene, settings: RenderSettings,
                         tracer: cuda_trace.Tracer, device: torch.device
                         ) -> Callable:
    """The record-walk route's `trace_fn(scene, o, d, tm, seed) -> (n, 3)`:
    the record kernel on the rays' planes, then the torch shade with the
    scene's own parameters.  Warns that `rr_start` is ignored, as the JAX
    package does."""
    from .diff import get_params
    from .integrator import shade_radiance, unpack_walk

    if settings.rr_start > 0:
        warnings.warn("rr_start ignored: image-textured scenes use the "
                      "record-mode walk (no in-kernel throughput)",
                      stacklevel=4)
    params = get_params(scene, device)
    walk = tracer.bind_walk_packed(settings.max_depth, settings.t_min)

    def trace_fn(scene_, o, d, tm, seed):
        data = unpack_walk(walk(o, d, tm, seed), tracer.need_p,
                           tracer.need_uv)
        return shade_radiance(scene_, params, data)

    return trace_fn


def _record_walk_renderer(scene: Scene, camera: Camera,
                          settings: RenderSettings,
                          tracer: cuda_trace.Tracer, device: torch.device
                          ) -> Callable[[int], torch.Tensor]:
    """The forward record-walk chunk of an image-textured scene
    (`engine/render.py:200-228`): each wave's torch-drawn rays walked by the
    record kernel on ray planes, then shaded in torch with the scene's own
    parameters."""
    trace_fn = record_walk_trace_fn(scene, settings, tracer, device)

    def chunk(base: int) -> torch.Tensor:
        with torch.no_grad():
            return chunk_sums(scene, camera, settings, int(base), trace_fn,
                              device)

    chunk.engine_name = "record-walk"
    return chunk


def compile_param_renderer(scene: Scene, camera: Camera,
                           settings: RenderSettings, engine: str = "auto",
                           device: torch.device | str = "cuda",
                           debug_stats: bool = False
                           ) -> Callable[[dict, int], torch.Tensor]:
    """Differentiable renderer `(params, base) -> (npix_pad, 3)` sums on
    `device` (`render.compile_param_renderer`, :231-310): the walk is
    detached, and only the shade of its record planes
    (`integrator.shade_packed`) depends on `params`
    (`engine.diff.get_params`).

    Routes, as the JAX package chooses them for `engine="pallas"`
    (`engine_name`):

    - "wavefront-record" when the JAX bake would stream the triangle table
      (`SceneBake.jax_tri_stream`: the 100k-triangle meshes) or `engine` is
      "wavefront", for a scene without media: `chunk_sums` over
      `wavefront.make_record_trace_wave`, the hit kernel's sorted record
      walk, with detached russian roulette from `settings.rr_start`;
      autograd follows the shade;
    - "record-walk" otherwise: the record kernel on each wave's ray planes
      (kernel 1c), which is `fused_diff.compile_fused_param_renderer` with
      `gen_rays=False` and its closed-form backward pass.  It has no
      russian roulette (ValueError for `rr_start > 0`, as JAX asserts).

    - "xla" for `engine="xla"`, or for "auto" on a scene that no kernel
      covers (`cuda_trace.unported_feature`): `chunk_sums` over
      `integrator.trace_diff`, the detached torch walk and the shade, each
      wave's draws from a generator seeded with the wave's seed; no
      russian roulette (ValueError).

    With `debug_stats` a wavefront-record chunk returns (sums,
    {"iterations": hit launches}); the other routes refuse it
    (`cuda_trace.Tracer.ray_launches` counts the record-walk's launches).
    "pallas" raises NotImplementedError for a scene outside the kernels'
    feature set."""
    device = torch.device(device)
    if _xla_wanted(scene, engine, ENGINES + ("wavefront",)):
        if settings.rr_start > 0:
            raise ValueError("russian roulette is not supported on the diff "
                             "path (its walk carries no throughput)")
        if debug_stats:
            raise ValueError("debug_stats: the wavefront-record route only")
        return _xla_param_renderer(scene, camera, settings, device)
    tracer = cuda_trace.Tracer(scene, device)  # raises for unported scenes
    if not ((tracer.bake.jax_tri_stream or engine == "wavefront")
            and tracer.supports_hit):
        from .fused_diff import compile_fused_param_renderer

        if settings.rr_start > 0:
            raise ValueError("russian roulette is not supported on the "
                             "record-walk route (its walk carries no "
                             "throughput)")
        if debug_stats:
            raise ValueError("debug_stats: the wavefront-record route only")
        chunk = compile_fused_param_renderer(scene, camera, settings,
                                             gen_rays=False, device=device,
                                             tracer=tracer)
        chunk.engine_name = "record-walk"
        return chunk

    from .integrator import shade_packed
    from .wavefront import make_record_trace_wave

    rr = settings.rr_start
    walk_wave = make_record_trace_wave(scene, tracer, settings.max_depth,
                                       settings.t_min, rr, device)
    bounces = [0]

    def chunk(params: dict, base: int):
        bounces[0] = 0

        def trace_fn(scene_, o, d, tm, seed):
            gen = torch.Generator(device=device).manual_seed(seed)
            planes, n = walk_wave(o, d, tm, gen)
            bounces[0] += n
            return shade_packed(scene_, params, *planes,
                                need_p=tracer.need_p, need_uv=tracer.need_uv,
                                need_scale=rr > 0)

        sums = chunk_sums(scene, camera, settings, int(base), trace_fn,
                          device)
        if debug_stats:
            return sums, {"iterations": bounces[0]}
        return sums

    chunk.engine_name = "wavefront-record"
    return chunk


def _xla_param_renderer(scene: Scene, camera: Camera,
                        settings: RenderSettings, device: torch.device
                        ) -> Callable[[dict, int], torch.Tensor]:
    """The differentiable xla chunk: `chunk_sums` over
    `integrator.trace_diff` with `params`."""
    from .intersect import geometry
    from .integrator import trace_diff

    geom = geometry(scene, device)

    def chunk(params: dict, base: int) -> torch.Tensor:
        def trace_fn(scene_, o, d, tm, seed):
            gen = torch.Generator(device=device).manual_seed(seed)
            return trace_diff(scene_, params, o, d, tm, gen,
                              max_depth=settings.max_depth,
                              t_min=settings.t_min, geom=geom)

        return chunk_sums(scene, camera, settings, int(base), trace_fn,
                          device)

    chunk.engine_name = "xla"
    return chunk


def render_linear(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    seed: Optional[int] = None,
    progress: Optional[Callable[[int, int, float], None]] = None,
    device: torch.device | str = "cuda",
    timer=None,
    checkpoint_dir: Optional[str] = None,
    debug_nans: bool = False,
    chunk_fn: Optional[Callable] = None,
) -> np.ndarray:
    """Full render -> (H, W, 3) mean linear radiance (host numpy).

    The chunk loop is the checkpoint grain: with `checkpoint_dir`, the
    float32 sums and the count of finished chunks are saved after every
    chunk, and a render of the same settings, seed and scene resumes after
    the last chunk saved, bit for bit: chunk c's base is the c-th draw of
    the seed's generator either way.  With `debug_nans`, or after
    `utils.profiling.enable_nan_debugging()`, a chunk whose sums hold a
    NaN raises FloatingPointError (one host read a chunk).

    chunk_fn: `chunk_fn(scene, camera, settings, base) -> (npix_pad, 3)`
    sums on `device` in place of `compile_renderer`'s chunk
    (`render.py:352-361`), such as `parallel.render.make_sharded_chunk_fn`;
    it gets the same bases.

    timer: optional `utils.profiling.PhaseTimer` collecting the build
    (scene bake), trace (chunks, synchronized) and io (checkpoint) phases;
    it also gets the engine the chunks took (`engine`, None with
    `chunk_fn`) and their host steps (`steps`, on the regen route).
    """
    phase = timer.phase if timer is not None else (lambda _name: nullcontext())
    debug_nans = debug_nans or nan_debugging()
    device = torch.device(device)
    h, w, npix, npix_pad, _, _ = _grid_geometry(settings)
    seed = settings.seed if seed is None else seed
    gen = torch.Generator().manual_seed(seed)
    sums = torch.zeros((npix_pad, 3), dtype=torch.float32, device=device)
    start, fp = 0, ""
    if checkpoint_dir is not None:
        from ..utils import checkpoint as ckpt

        fp = ckpt.fingerprint(settings, seed, scene)
        state = ckpt.load(checkpoint_dir, expected_shape=(npix_pad, 3), fp=fp)
        if state is not None:
            sums = torch.from_numpy(state[0]).to(device)
            start = state[1]
            logger.info("resuming after chunk %d of %d", start,
                        settings.num_chunks)
    if chunk_fn is None:
        with phase("build"):
            chunk = compile_renderer(scene, camera, settings, device)
        logger.info("render engine: %s on %s", chunk.engine_name, device)
    else:
        def chunk(base: int) -> torch.Tensor:
            return chunk_fn(scene, camera, settings, base)
    for c in range(settings.num_chunks):
        base = cuda_trace.chunk_seed(gen)  # drawn for every chunk, done or not
        if c < start:
            continue
        t0 = time.perf_counter()
        with phase("trace"):
            out = chunk(base)
            if debug_nans and bool(torch.isnan(out).any()):
                raise FloatingPointError(
                    f"NaN in the sums of chunk {c + 1} of "
                    f"{settings.num_chunks} (base seed {base})")
            sums += out
            synchronize(device)
        if checkpoint_dir is not None:
            with phase("io"):
                ckpt.save(checkpoint_dir, sums.cpu().numpy(), c + 1, fp=fp)
        if progress is not None:
            progress(c + 1, settings.num_chunks, time.perf_counter() - t0)
    if timer is not None:
        timer.engine = getattr(chunk, "engine_name", None)
        timer.steps = getattr(chunk, "steps", None)
    out = sums[:npix].cpu().numpy()
    return (out / float(settings.rays_per_pixel)).reshape(h, w, 3)


def render(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    seed: Optional[int] = None,
    progress: Optional[Callable[[int, int, float], None]] = None,
    device: torch.device | str = "cuda",
    checkpoint_dir: Optional[str] = None,
    timer=None,
) -> np.ndarray:
    """Full render -> (H, W, 3) gamma-2 image in [0, 1) (reference `draw`,
    `render.h:118-174`), resumable from `checkpoint_dir`; `timer` as
    `render_linear`'s."""
    linear = render_linear(scene, camera, settings, seed=seed,
                           progress=progress, device=device, timer=timer,
                           checkpoint_dir=checkpoint_dir)
    return film.finalize(linear * settings.rays_per_pixel,
                         settings.rays_per_pixel)
