"""Write the pinned JAX goldens that the PyTorch port is held to.

Runs the JAX package on the CPU (the Pallas megakernel in interpret mode)
and writes, under `tests/data/torch_port/`:

- `cornell_32.npz`, the forward path: one chunk of the Cornell box at
  32x32, 2 spp, depth 3, as `compile_renderer(engine="pallas")` returns it
  ((npix_pad, 3) float32 radiance sums), with the int32 base seed and the
  settings that produced it;
- `cornell_grad_32.npz`, the training path: the same chunk shape in waves
  of 512 rays through `compile_fused_param_renderer(gen_rays=True)`: every
  wave's record plane from `PallasTracer.walk_packed_pixels` (cropped to
  the wave, (spp * waves, depth, 512) int32 in (sample, wave) order), the
  fused chunk's primal, and the gradients of mean((chunk - target)**2)
  with respect to tex_c1, tex_c2 and atlas_data, with the base seed, the
  target and the settings;
- `<scene>_32.npz` for each dense scene the forward kernel covers beyond
  the Cornell box (`SCENES`): one forward chunk at width 32 (the scene's
  aspect), 2 spp, depth 3, as `cornell_32.npz`; for the scenes whose
  textures are all solid (`RECORD_SCENES`) also the record planes of the
  same chunk in waves of 512 rays (`planes`, (spp * waves, depth, 512)
  int32, with `record_ray_batch`);
- `big_scene1_32`: the same forward chunk of `big_scene1` (the megakernel
  route at 2 spp, with the sphere BVH);
- `big_scene1_hit`: `PallasTracer.hit` (sub 8) on 4,096 camera rays of
  `big_scene1` (10% of the lanes dead) and on one bounce of them (the hit
  points, `materials.scatter`'s directions, alive where the path goes on),
  beside the XLA engine's `closest_hit` on the same rays: the rays
  (`o0 d0 tm0 alive0`, `o1 ...`), the kernel's outputs (`packed0 p0 u0 v0
  normal0`, ...) and closest_hit's (`ref_hit0 ref_mat0 ref_p0
  ref_normal0`, ...);
- `big_scene1_regen`: one chunk of `compile_regen_renderer` (sub 8) on
  `big_scene1` at width 48, 16 spp, depth 8, waves of 1,024 rays, with its
  step and stream counts;
- `triangles_32`: the forward chunk of `triangles` (the megakernel route
  with its triangle BVH), as `<scene>_32.npz`;
- `mesh_hit` and `mesh_regen`: `big_scene1_hit` and `big_scene1_regen` on
  the small mesh scene (`mesh_scene`: a 16 x 16 UV sphere of 512 triangles
  at the backpack stand-in's framing, on the backpack's ground sphere, under
  its camera), the hit golden with the hit tier's slot outputs (`slot0`,
  ...) and its slot -> triangle id map (`perm`);
- `<scene>_rec32` for the scenes of `REC32_SCENES` (kernel 1b beyond the
  packed plane: the hit-point planes and the BVH walks in record mode):
  every wave's planes from `PallasTracer.walk_packed_pixels` at width 32,
  2 spp, depth 3, in waves of 512 rays (`planes`, (spp * waves, depth,
  512) int32; `p`, (spp * waves, 3, depth, 512) float32 when the scene
  needs hit points); for a camera with a lens, XLA's cosine and sine of
  each lane's lens angle (`lens_cs`, (spp * waves, 2, 512) float32: where
  torch's or CUDA's differ by an ulp, the lane's camera ray differs, and a
  grazing ray may hit another primitive at bounce 0); for `two_spheres`
  also the fused chunk's primal and L2-loss gradients
  (`compile_fused_param_renderer(gen_rays=True)`, whose walks are these
  planes), as `cornell_grad_32`;
- `<scene>_rays` for cornell_box and big_scene1 (kernel 1c, the ray-plane
  input): 512 camera rays drawn by JAX (`o d tm`), the key (`key`, its raw
  data) and the int32 seed `PallasTracer._tile_args` draws from it
  (`seed`), `PallasTracer.walk_packed` (`planes`, `p`) and `__call__`
  (`radiance`) on them at depth 8;
- `perlin_regen`: `big_scene1_regen` on `perlin_field`, 70 small spheres on
  a noise-textured ground sphere (a sphere BVH whose albedo needs the
  perlin branches of `eval_texture` on the regen route);
- `<probe>_uv32` for the image probes of `raytracing_gpu_tpu_torch.models.
  probes` (`UV_PROBES`: kernel 1b's uv planes, `need_uv`): every wave's
  planes from `PallasTracer.walk_packed_pixels` at width 32, 2 spp, depth
  3, in waves of 512 rays (`planes`, and `uv`, (spp * waves, 2, depth,
  512) float32); the synthetic images are made again from their seeds;
- `earth_rays`: `<scene>_rays` on `earth` with the synthetic map
  `EARTH_MAP` (kernel 1c with the uv planes: `planes`, `uv`, `radiance`
  absent, since the forward kernel refuses image scenes);
- `earth_fused32`: `earth` with `EARTH_MAP` at 32x32, 2 spp, depth 4,
  waves of 512 rays: every wave's planes and uv, XLA's lens cos/sin, and
  the fused chunk's (`compile_fused_param_renderer(gen_rays=True)`)
  primal and L2-loss gradients, `grad_atlas_data` among them;
- `<scene>_d50` for `cornell_smoke` (media: the longest paths) and
  `triangles` (the triangle BVH): the forward chunk of `<scene>_32` at the
  reference depth 50 with russian roulette from bounce `DEEP_RR_START`
  (`rr_start` is saved beside the settings);
- `mesh_box_d50`: the same for `models.probes.mesh_box`, a closed box of
  triangles whose paths run past bounce 4 (`triangles`' paths end
  sooner), so that kernel 1d-t's roulette is held at depth 50;
- `big_scene1_regen_d50`: `big_scene1_regen` at depth 50 with russian
  roulette from bounce `DEEP_RR_START`.

The JAX `earth` takes its map from `<REFERENCE_ROOT>/textures/
earthmap.jpg`, so the synthetic map is written there, as a PNG under that
name (PIL reads the content, and PNG keeps the k/255 values), in a
temporary directory.

The port's CPU tests hold its plain versions to these files, and
`chip_smoke.py` holds the CUDA kernels to them, so the card's output is tied
to the JAX reference without JAX on that machine.

    python tools/make_torch_goldens.py [cornell_32] [cornell_grad_32] [first_32] ...

With no names it writes them all; name the one you mean to rewrite, since
rewriting a file changes its zip timestamps.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_port")
KEY_SEED = 2024
GRAD_TARGET = 0.25
SCENES = ("basic", "first", "two_spheres", "two_perlin_spheres",
          "cornell_smoke", "big_scene1", "triangles")
RECORD_SCENES = ("first", "cornell_smoke")
RECORD_RAY_BATCH = 512
HIT_RAYS = 4096
HIT_DEAD = 0.1   # share of dead lanes in the hit golden
REGEN = dict(image_width=48, spp_per_chunk=16, num_chunks=1, max_depth=8,
             ray_batch=1024)
REC32_SCENES = ("two_spheres", "two_perlin_spheres", "big_scene1",
                "triangles")
RAY_SCENES = ("cornell_box", "big_scene1")
RAYS = 512
RAYS_DEPTH = 8
UV_PROBES = ("image_probe", "image_spheres", "image_mesh")
EARTH_MAP = (64, 128, 7)  # height, width, seed of the synthetic earth map
EARTH_FUSED_DEPTH = 4
DEEP_DEPTH = 50      # the reference depth (`render.h:27`)
DEEP_RR_START = 4    # russian roulette from bounce 4, as the gallery
DEEP_SCENES = ("cornell_smoke", "triangles")
DEEP_PROBES = ("mesh_box",)  # scenes of models.probes with a d50 golden


def forward_golden() -> None:
    import jax
    import numpy as np

    from raytracing_gpu_tpu.core.config import RenderSettings
    from raytracing_gpu_tpu.engine.render import compile_renderer
    from raytracing_gpu_tpu.models import scenes
    from raytracing_gpu_tpu.ops import pallas_trace

    out = os.path.join(DATA, "cornell_32.npz")
    sd = scenes.get("cornell_box")
    st = RenderSettings(image_width=32, aspect_ratio=sd.aspect,
                        spp_per_chunk=2, num_chunks=1, max_depth=3,
                        ray_batch=65536)
    key = jax.random.PRNGKey(KEY_SEED)
    base = int(pallas_trace.chunk_seed(key))
    chunk = compile_renderer(sd.scene, sd.camera, st, engine="pallas")
    sums = np.asarray(chunk(key), np.float32)
    np.savez_compressed(
        out, base=np.int32(base), key_seed=np.int32(KEY_SEED), sums=sums,
        image_width=st.image_width, image_height=st.image_height,
        spp_per_chunk=st.spp_per_chunk, max_depth=st.max_depth,
        ray_batch=st.ray_batch, t_min=np.float32(st.t_min))
    print(f"wrote {out}: base {base}, sums {sums.shape}, "
          f"mean {sums.mean(0)}")


def grad_golden() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracing_gpu_tpu.core.config import RenderSettings
    from raytracing_gpu_tpu.engine import diff
    from raytracing_gpu_tpu.engine.fused_diff import (
        compile_fused_param_renderer)
    from raytracing_gpu_tpu.models import scenes
    from raytracing_gpu_tpu.ops import pallas_trace

    out = os.path.join(DATA, "cornell_grad_32.npz")
    sd = scenes.get("cornell_box")
    st = RenderSettings(image_width=32, aspect_ratio=sd.aspect,
                        spp_per_chunk=2, num_chunks=1, max_depth=3,
                        ray_batch=512)
    key = jax.random.PRNGKey(KEY_SEED)
    base = int(pallas_trace.chunk_seed(key))
    h, w, b = st.image_height, st.image_width, st.ray_batch
    nb = h * w // b
    tracer = pallas_trace.PallasTracer(sd.scene)
    planes = np.stack([
        np.asarray(tracer.walk_packed_pixels(
            sd.camera, h, w, bid * b, b, pallas_trace.wave_seed(base, s, bid),
            max_depth=st.max_depth, t_min=st.t_min)[0]
        ).reshape(st.max_depth, -1)[:, :b]
        for s in range(st.spp_per_chunk) for bid in range(nb)])
    chunk = compile_fused_param_renderer(sd.scene, sd.camera, st,
                                         gen_rays=True)
    params = diff.get_params(sd.scene)
    primal = np.asarray(chunk(params, key), np.float32)
    grads = jax.grad(
        lambda p: jnp.mean((chunk(p, key) - GRAD_TARGET) ** 2))(params)
    np.savez_compressed(
        out, base=np.int32(base), key_seed=np.int32(KEY_SEED),
        planes=planes.astype(np.int32), primal=primal,
        target=np.float32(GRAD_TARGET),
        **{f"grad_{k}": np.asarray(v, np.float32) for k, v in grads.items()},
        image_width=st.image_width, image_height=st.image_height,
        spp_per_chunk=st.spp_per_chunk, max_depth=st.max_depth,
        ray_batch=st.ray_batch, t_min=np.float32(st.t_min))
    print(f"wrote {out}: base {base}, planes {planes.shape}, primal "
          f"{primal.shape}, grads {({k: v.shape for k, v in grads.items()})}")


def scene_golden(name: str, max_depth: int = 3, rr_start: int = 0,
                 suffix: str = "32") -> None:
    import jax
    import numpy as np

    from raytracing_gpu_tpu.core.config import RenderSettings
    from raytracing_gpu_tpu.engine.render import compile_renderer
    from raytracing_gpu_tpu.models import scenes
    from raytracing_gpu_tpu.ops import pallas_trace

    out = os.path.join(DATA, f"{name}_{suffix}.npz")
    if name in DEEP_PROBES:
        from raytracing_gpu_tpu.core.camera import Camera
        from raytracing_gpu_tpu.scene.builder import SceneBuilder
        from raytracing_gpu_tpu_torch.models import probes

        sd = scenes.SceneDef(*getattr(probes, name)(SceneBuilder, Camera))
    else:
        sd = scenes.get(name)
    st = RenderSettings(image_width=32, aspect_ratio=sd.aspect,
                        spp_per_chunk=2, num_chunks=1, max_depth=max_depth,
                        ray_batch=65536, rr_start=rr_start)
    key = jax.random.PRNGKey(KEY_SEED)
    base = int(pallas_trace.chunk_seed(key))
    chunk = compile_renderer(sd.scene, sd.camera, st, engine="pallas")
    if chunk.engine_name != "megakernel":
        raise RuntimeError(f"{name}: route {chunk.engine_name}, not the "
                           "megakernel")
    sums = np.asarray(chunk(key), np.float32)
    extra = {}
    if name in RECORD_SCENES and suffix == "32":
        h, w, b = st.image_height, st.image_width, RECORD_RAY_BATCH
        tracer = pallas_trace.PallasTracer(sd.scene)
        extra = dict(record_ray_batch=b, planes=np.stack([
            np.asarray(tracer.walk_packed_pixels(
                sd.camera, h, w, bid * b, b,
                pallas_trace.wave_seed(base, s, bid),
                max_depth=st.max_depth, t_min=st.t_min)[0]
            ).reshape(st.max_depth, -1)[:, :b]
            for s in range(st.spp_per_chunk)
            for bid in range(-(-h * w // b))]).astype(np.int32))
    np.savez_compressed(
        out, base=np.int32(base), key_seed=np.int32(KEY_SEED), sums=sums,
        image_width=st.image_width, image_height=st.image_height,
        aspect_ratio=np.float64(sd.aspect),
        spp_per_chunk=st.spp_per_chunk, max_depth=st.max_depth,
        ray_batch=st.ray_batch, t_min=np.float32(st.t_min),
        rr_start=st.rr_start, **extra)
    print(f"wrote {out}: base {base}, sums {sums.shape}, mean "
          f"{sums.mean(0)}, planes {extra.get('planes', np.zeros(0)).shape}")


MESH_RES = (16, 16)   # the small mesh scene's UV sphere


def mesh_scene():
    """The small mesh scene of the triangle goldens, as a JAX SceneDef: the
    backpack scene with its 100,352-triangle stand-in replaced by a
    MESH_RES UV sphere of the same framing (`models/scenes.py:_add_obj`,
    standin_scale 0.45)."""
    from raytracing_gpu_tpu.models import scenes
    from raytracing_gpu_tpu.scene.builder import SKY, SceneBuilder

    b = SceneBuilder(background=SKY)
    tex = b.solid((0.8, 0.2, 0.2))
    v, f, uvs, n = scenes._uv_sphere(*MESH_RES)
    v = v * 0.45
    v[:, 1] += 0.45
    b.mesh(v, f, b.lambertian(tex), uvs=uvs, normals=n)
    b.sphere((0, -100, -1), 100, b.lambertian((0, 1, 0)))
    bp = scenes.get("backpack")
    return scenes.SceneDef(b.build(), bp.camera, bp.aspect)


def hit_golden(name: str = "big_scene1") -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracing_gpu_tpu.engine.intersect import closest_hit
    from raytracing_gpu_tpu.engine.wavefront import (pack_attr_table,
                                                     resolve_hit_packed)
    from raytracing_gpu_tpu.models import scenes
    from raytracing_gpu_tpu.ops import pallas_trace
    from raytracing_gpu_tpu.scene import materials

    out = os.path.join(DATA, f"{name}_hit.npz")
    sd = mesh_scene() if name == "mesh" else scenes.get(name)
    tracer = pallas_trace.PallasTracer(sd.scene)
    key = jax.random.PRNGKey(KEY_SEED)
    k_px, k_py, k_cam, k_alive, k_scat = jax.random.split(key, 5)
    n = HIT_RAYS
    o, d, tm = sd.camera.get_rays(k_cam, jax.random.uniform(k_px, (n,)),
                                  jax.random.uniform(k_py, (n,)))
    alive = jax.random.uniform(k_alive, (n,)) >= HIT_DEAD
    attr = pack_attr_table(sd.scene, tracer.bake.tri_perm)
    arrays = {}
    for b in range(2):
        packed, p, u, v, normal, slot = tracer.hit(o, d, tm, alive, sub=8)
        ref = closest_hit(sd.scene, o, d, tm, jax.random.PRNGKey(9))
        arrays.update({f"{k}{b}": np.asarray(x) for k, x in (
            ("o", o), ("d", d), ("tm", tm), ("alive", alive),
            ("packed", packed), ("p", p), ("u", u), ("v", v),
            ("normal", normal), ("slot", slot), ("ref_hit", ref.hit),
            ("ref_mat", ref.mat_id),
            ("ref_p", ref.p), ("ref_normal", ref.normal))})
        # one bounce: from the hit points along the scattered directions
        rec = resolve_hit_packed(attr, packed, p, u, v, normal, slot, d)
        sc = materials.scatter(sd.scene, k_scat, d, rec.p, rec.normal,
                               rec.front_face, rec.u, rec.v, rec.mat_id)
        alive = alive & rec.hit & sc.ok
        o = jnp.where(alive[:, None], rec.p, o)
        d = jnp.where(alive[:, None], sc.direction, d)
    if name == "mesh":
        arrays["perm"] = np.asarray(tracer.bake.tri_perm)
    else:  # no triangles: the slot plane is all zeros
        arrays = {k: a for k, a in arrays.items() if not k.startswith("slot")}
    np.savez_compressed(out, key_seed=np.int32(KEY_SEED), **arrays)
    print(f"wrote {out}: {n} rays x 2 bounces, hits "
          f"{[int(((arrays[f'packed{b}'] >> 16) & 1).sum()) for b in (0, 1)]}")


def regen_golden(name: str = "big_scene1", deep: bool = False) -> None:
    """One regen chunk at `REGEN`, or with `deep` at depth DEEP_DEPTH with
    russian roulette from DEEP_RR_START (`<name>_regen_d50`)."""
    import jax
    import numpy as np

    from raytracing_gpu_tpu.core.config import RenderSettings
    from raytracing_gpu_tpu.engine.wavefront import compile_regen_renderer
    from raytracing_gpu_tpu.models import scenes

    regen = (dict(REGEN, max_depth=DEEP_DEPTH, rr_start=DEEP_RR_START)
             if deep else REGEN)
    out = os.path.join(DATA, f"{name}_regen{'_d50' if deep else ''}.npz")
    sd = mesh_scene() if name == "mesh" else scenes.get(name)
    st = RenderSettings(aspect_ratio=sd.aspect, **regen)
    chunk = compile_regen_renderer(sd.scene, sd.camera, st, debug_stats=True,
                                   hit_sub=8)
    sums, stats = chunk(jax.random.PRNGKey(KEY_SEED))
    sums = np.asarray(sums, np.float32)
    np.savez_compressed(
        out, key_seed=np.int32(KEY_SEED), sums=sums,
        iterations=np.int32(stats["iterations"]),
        stream=np.int32(stats["stream"]), aspect_ratio=np.float64(sd.aspect),
        t_min=np.float32(st.t_min), **regen)
    print(f"wrote {out}: sums {sums.shape}, mean "
          f"{sums[:st.num_pixels].mean(0) / st.spp_per_chunk}, {stats}")


def record_golden(name: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracing_gpu_tpu.core.config import RenderSettings
    from raytracing_gpu_tpu.engine import diff
    from raytracing_gpu_tpu.engine.fused_diff import (
        compile_fused_param_renderer)
    from raytracing_gpu_tpu.models import scenes
    from raytracing_gpu_tpu.ops import pallas_trace

    out = os.path.join(DATA, f"{name}_rec32.npz")
    sd = scenes.get(name)
    st = RenderSettings(image_width=32, aspect_ratio=sd.aspect,
                        spp_per_chunk=2, num_chunks=1, max_depth=3,
                        ray_batch=RECORD_RAY_BATCH)
    key = jax.random.PRNGKey(KEY_SEED)
    base = int(pallas_trace.chunk_seed(key))
    h, w, b = st.image_height, st.image_width, st.ray_batch
    tracer = pallas_trace.PallasTracer(sd.scene)
    waves = [[np.asarray(x).reshape(st.max_depth, -1)[:, :b]
              for x in tracer.walk_packed_pixels(
                  sd.camera, h, w, bid * b, b,
                  pallas_trace.wave_seed(base, s, bid),
                  max_depth=st.max_depth, t_min=st.t_min)]
             for s in range(st.spp_per_chunk)
             for bid in range(-(-h * w // b))]
    extra = dict(planes=np.stack([x[0] for x in waves]).astype(np.int32))
    if float(sd.camera.lens_radius) != 0.0:
        extra["lens_cs"] = np.stack([
            lens_cos_sin(pallas_trace.wave_seed(base, s, bid), b)
            for s in range(st.spp_per_chunk)
            for bid in range(-(-h * w // b))]).astype(np.float32)
    if tracer.need_p:
        extra["p"] = np.stack([np.stack(x[1:4]) for x in waves]).astype(
            np.float32)
    if name == "two_spheres":
        chunk = compile_fused_param_renderer(sd.scene, sd.camera, st,
                                             gen_rays=True)
        params = diff.get_params(sd.scene)
        grads = jax.grad(
            lambda p: jnp.mean((chunk(p, key) - GRAD_TARGET) ** 2))(params)
        extra.update(primal=np.asarray(chunk(params, key), np.float32),
                     target=np.float32(GRAD_TARGET),
                     **{f"grad_{k}": np.asarray(v, np.float32)
                        for k, v in grads.items()})
    np.savez_compressed(
        out, base=np.int32(base), key_seed=np.int32(KEY_SEED),
        need_p=bool(tracer.need_p), image_width=st.image_width,
        image_height=st.image_height, aspect_ratio=np.float64(sd.aspect),
        spp_per_chunk=st.spp_per_chunk, max_depth=st.max_depth,
        ray_batch=st.ray_batch, t_min=np.float32(st.t_min), **extra)
    print(f"wrote {out}: base {base}, need_p {tracer.need_p}, "
          f"{({k: v.shape for k, v in extra.items()})}")


def lens_cos_sin(seed: int, n: int):
    """(2, n): XLA's cos and sin of the lens angle of lanes 0..n-1 of an
    in-kernel camera call with int32 seed `seed` (pallas_trace.py:902-907,
    :1585-1594)."""
    import math

    import jax.numpy as jnp
    import numpy as np

    from raytracing_gpu_tpu.ops import pallas_trace

    lane = jnp.arange(n, dtype=jnp.uint32)
    base = pallas_trace._pcg_hash(
        lane ^ (jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
                * jnp.uint32(0x85EBCA6B)))
    cdraw = base + jnp.uint32(0x7F4A7C15) * jnp.uint32(0x68E31DA4)
    theta = (2.0 * math.pi) * pallas_trace._uniform(cdraw, 2)
    return np.stack([np.asarray(jnp.cos(theta)), np.asarray(jnp.sin(theta))])


def rays_golden(name: str) -> None:
    import jax
    import numpy as np

    from raytracing_gpu_tpu.models import scenes
    from raytracing_gpu_tpu.ops import pallas_trace

    out = os.path.join(DATA, f"{name}_rays.npz")
    sd = scenes.get(name)
    tracer = pallas_trace.PallasTracer(sd.scene)
    k_px, k_py, k_cam, k_trace = jax.random.split(
        jax.random.PRNGKey(KEY_SEED), 4)
    n = RAYS
    o, d, tm = sd.camera.get_rays(k_cam, jax.random.uniform(k_px, (n,)),
                                  jax.random.uniform(k_py, (n,)))
    # the seed both calls draw from k_trace (`_tile_args`)
    _, seed, _ = tracer._tile_args(o, d, tm, k_trace)
    planes = [np.asarray(x) for x in tracer.walk_packed(
        o, d, tm, k_trace, max_depth=RAYS_DEPTH)]
    radiance = np.asarray(tracer(sd.scene, o, d, tm, k_trace,
                                 max_depth=RAYS_DEPTH))
    extra = {"p": np.stack(planes[1:4])} if tracer.need_p else {}
    np.savez_compressed(
        out, key_seed=np.int32(KEY_SEED),
        key=np.asarray(jax.random.key_data(k_trace)),
        seed=np.int32(np.asarray(seed)[0]), o=np.asarray(o), d=np.asarray(d),
        tm=np.asarray(tm), planes=planes[0].astype(np.int32),
        radiance=radiance.astype(np.float32), max_depth=RAYS_DEPTH,
        t_min=np.float32(0.001), need_p=bool(tracer.need_p), **extra)
    print(f"wrote {out}: {n} rays, seed {int(np.asarray(seed)[0])}, planes "
          f"{planes[0].shape}, need_p {tracer.need_p}, mean radiance "
          f"{radiance.mean(0)}")


def perlin_field(builder_cls, camera_cls):
    """70 spheres of radius 0.2 on a noise(4.0) ground sphere, under a
    16:9 camera: a sphere BVH (more than 64 spheres) whose ground needs the
    perlin branches of `eval_texture`.  Returns (scene, camera, aspect);
    tests/test_torch_param.py builds the same scene."""
    b = builder_cls()
    b.sphere((0, -1000, 0), 1000, b.lambertian(b.noise(4.0)))
    for i in range(70):
        x, z = i % 10 - 4.5, i // 10 - 3.0
        b.sphere((0.8 * x, 0.2, 0.8 * z), 0.2,
                 b.lambertian((0.1 + 0.012 * i, 0.5, 0.9 - 0.01 * i)))
    cam = camera_cls.make((0, 3, 7), (0, 0, 0), (0, 1, 0), 40.0, 16 / 9,
                          0.0, 10.0, 0.0, 1.0)
    return b.build(), cam, 16 / 9


def perlin_regen_golden() -> None:
    import jax
    import numpy as np

    from raytracing_gpu_tpu.core.camera import Camera
    from raytracing_gpu_tpu.core.config import RenderSettings
    from raytracing_gpu_tpu.engine.render import compile_renderer
    from raytracing_gpu_tpu.engine.wavefront import compile_regen_renderer
    from raytracing_gpu_tpu.scene.builder import SceneBuilder

    out = os.path.join(DATA, "perlin_regen.npz")
    scene, cam, aspect = perlin_field(SceneBuilder, Camera)
    st = RenderSettings(aspect_ratio=aspect, **REGEN)
    engine = compile_renderer(scene, cam, st, engine="pallas").engine_name
    chunk = compile_regen_renderer(scene, cam, st, debug_stats=True,
                                   hit_sub=8)
    sums, stats = chunk(jax.random.PRNGKey(KEY_SEED))
    sums = np.asarray(sums, np.float32)
    np.savez_compressed(
        out, key_seed=np.int32(KEY_SEED), sums=sums,
        iterations=np.int32(stats["iterations"]),
        stream=np.int32(stats["stream"]), aspect_ratio=np.float64(aspect),
        t_min=np.float32(st.t_min), engine=engine, **REGEN)
    print(f"wrote {out}: engine {engine}, sums {sums.shape}, mean "
          f"{sums[:st.num_pixels].mean(0) / st.spp_per_chunk}, {stats}")


def jax_earth(image):
    """The JAX package's `earth` with `image` as its map: written as
    `textures/earthmap.jpg` (PNG content) under a temporary REFERENCE_ROOT,
    which `models/scenes.py` reads at import."""
    import tempfile

    from PIL import Image

    from raytracing_gpu_tpu.models import scenes

    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "textures"))
        k = (image * 255.0).round().astype("uint8")
        Image.fromarray(k).save(os.path.join(root, "textures",
                                              "earthmap.jpg"), format="PNG")
        old, scenes.REFERENCE_ROOT = scenes.REFERENCE_ROOT, root
        try:
            return scenes.get("earth")
        finally:
            scenes.REFERENCE_ROOT = old


def earth_map():
    from raytracing_gpu_tpu_torch.models import probes

    return probes.synthetic_image(*EARTH_MAP)


def uv_walk(tracer, camera, st, base: int) -> dict:
    """Every wave's record planes of a chunk from
    `PallasTracer.walk_packed_pixels`: `planes` (spp * waves, depth, b)
    int32, `uv` (spp * waves, 2, depth, b) float32, and for a camera with a
    lens XLA's cos and sin of each lane's lens angle (`lens_cs`)."""
    import numpy as np

    from raytracing_gpu_tpu.ops import pallas_trace

    h, w, b = st.image_height, st.image_width, st.ray_batch
    waves = [(bid, pallas_trace.wave_seed(base, s, bid))
             for s in range(st.spp_per_chunk)
             for bid in range(-(-h * w // b))]
    walks = [[np.asarray(x).reshape(st.max_depth, -1)[:, :b]
              for x in tracer.walk_packed_pixels(
                  camera, h, w, bid * b, b, seed, max_depth=st.max_depth,
                  t_min=st.t_min)]
             for bid, seed in waves]
    out = dict(planes=np.stack([x[0] for x in walks]).astype(np.int32),
               uv=np.stack([np.stack(x[-2:]) for x in walks]).astype(
                   np.float32))
    if float(camera.lens_radius) != 0.0:
        out["lens_cs"] = np.stack([lens_cos_sin(seed, b)
                                   for _, seed in waves]).astype(np.float32)
    return out


def uv_golden(name: str) -> None:
    import jax
    import numpy as np

    from raytracing_gpu_tpu.core.camera import Camera
    from raytracing_gpu_tpu.core.config import RenderSettings
    from raytracing_gpu_tpu.ops import pallas_trace
    from raytracing_gpu_tpu.scene.builder import SceneBuilder
    from raytracing_gpu_tpu_torch.models import probes

    out = os.path.join(DATA, f"{name}_uv32.npz")
    scene, cam, aspect = getattr(probes, name)(SceneBuilder, Camera)
    st = RenderSettings(image_width=32, aspect_ratio=aspect,
                        spp_per_chunk=2, num_chunks=1, max_depth=3,
                        ray_batch=RECORD_RAY_BATCH)
    base = int(pallas_trace.chunk_seed(jax.random.PRNGKey(KEY_SEED)))
    tracer = pallas_trace.PallasTracer(scene)
    assert tracer.need_uv
    extra = uv_walk(tracer, cam, st, base)
    np.savez_compressed(
        out, base=np.int32(base), key_seed=np.int32(KEY_SEED),
        need_p=bool(tracer.need_p), image_width=st.image_width,
        image_height=st.image_height, aspect_ratio=np.float64(aspect),
        spp_per_chunk=st.spp_per_chunk, max_depth=st.max_depth,
        ray_batch=st.ray_batch, t_min=np.float32(st.t_min), **extra)
    print(f"wrote {out}: base {base}, "
          f"{({k: v.shape for k, v in extra.items()})}")


def earth_rays_golden() -> None:
    import jax
    import numpy as np

    from raytracing_gpu_tpu.ops import pallas_trace

    out = os.path.join(DATA, "earth_rays.npz")
    sd = jax_earth(earth_map())
    tracer = pallas_trace.PallasTracer(sd.scene)
    assert tracer.need_uv and not pallas_trace.supports_forward(sd.scene)
    k_px, k_py, k_cam, k_trace = jax.random.split(
        jax.random.PRNGKey(KEY_SEED), 4)
    n = RAYS
    o, d, tm = sd.camera.get_rays(k_cam, jax.random.uniform(k_px, (n,)),
                                  jax.random.uniform(k_py, (n,)))
    _, seed, _ = tracer._tile_args(o, d, tm, k_trace)
    planes = [np.asarray(x) for x in tracer.walk_packed(
        o, d, tm, k_trace, max_depth=RAYS_DEPTH)]
    np.savez_compressed(
        out, key_seed=np.int32(KEY_SEED),
        key=np.asarray(jax.random.key_data(k_trace)),
        seed=np.int32(np.asarray(seed)[0]), o=np.asarray(o), d=np.asarray(d),
        tm=np.asarray(tm), planes=planes[0].astype(np.int32),
        uv=np.stack(planes[-2:]).astype(np.float32), max_depth=RAYS_DEPTH,
        t_min=np.float32(0.001), earth_map=np.asarray(EARTH_MAP))
    print(f"wrote {out}: {n} rays, seed {int(np.asarray(seed)[0])}, planes "
          f"{planes[0].shape}, hits {int(((planes[0] >> 16) & 1).sum())}")


def earth_fused_golden() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracing_gpu_tpu.core.config import RenderSettings
    from raytracing_gpu_tpu.engine import diff
    from raytracing_gpu_tpu.engine.fused_diff import (
        compile_fused_param_renderer)
    from raytracing_gpu_tpu.ops import pallas_trace

    out = os.path.join(DATA, "earth_fused32.npz")
    sd = jax_earth(earth_map())
    st = RenderSettings(image_width=32, aspect_ratio=1.0, spp_per_chunk=2,
                        num_chunks=1, max_depth=EARTH_FUSED_DEPTH,
                        ray_batch=RECORD_RAY_BATCH)
    key = jax.random.PRNGKey(KEY_SEED)
    base = int(pallas_trace.chunk_seed(key))
    tracer = pallas_trace.PallasTracer(sd.scene)
    extra = uv_walk(tracer, sd.camera, st, base)
    chunk = compile_fused_param_renderer(sd.scene, sd.camera, st,
                                         gen_rays=True)
    params = diff.get_params(sd.scene)
    grads = jax.grad(
        lambda p: jnp.mean((chunk(p, key) - GRAD_TARGET) ** 2))(params)
    np.savez_compressed(
        out, base=np.int32(base), key_seed=np.int32(KEY_SEED),
        image_width=st.image_width, image_height=st.image_height,
        aspect_ratio=np.float64(1.0), spp_per_chunk=st.spp_per_chunk,
        max_depth=st.max_depth, ray_batch=st.ray_batch,
        t_min=np.float32(st.t_min), earth_map=np.asarray(EARTH_MAP),
        primal=np.asarray(chunk(params, key), np.float32),
        target=np.float32(GRAD_TARGET),
        **{f"grad_{k}": np.asarray(v, np.float32) for k, v in grads.items()},
        **extra)
    print(f"wrote {out}: base {base}, nonzero atlas gradients "
          f"{int((np.asarray(grads['atlas_data']) != 0).sum())}, "
          f"{({k: v.shape for k, v in extra.items()})}")


GOLDENS = {"cornell_32": forward_golden, "cornell_grad_32": grad_golden,
           **{f"{n}_32": (lambda n=n: scene_golden(n)) for n in SCENES},
           "big_scene1_hit": hit_golden, "big_scene1_regen": regen_golden,
           "mesh_hit": lambda: hit_golden("mesh"),
           "mesh_regen": lambda: regen_golden("mesh"),
           **{f"{n}_rec32": (lambda n=n: record_golden(n))
              for n in REC32_SCENES},
           **{f"{n}_rays": (lambda n=n: rays_golden(n)) for n in RAY_SCENES},
           "perlin_regen": perlin_regen_golden,
           **{f"{n}_uv32": (lambda n=n: uv_golden(n)) for n in UV_PROBES},
           "earth_rays": earth_rays_golden,
           "earth_fused32": earth_fused_golden,
           **{f"{n}_d50": (lambda n=n: scene_golden(
               n, DEEP_DEPTH, DEEP_RR_START, "d50"))
              for n in DEEP_SCENES + DEEP_PROBES},
           "big_scene1_regen_d50": lambda: regen_golden(deep=True)}


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or list(GOLDENS)
    unknown = [n for n in names if n not in GOLDENS]
    if unknown:
        raise SystemExit(f"unknown golden {unknown}; choose from "
                         f"{list(GOLDENS)}")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(DATA, exist_ok=True)
    for name in names:
        GOLDENS[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
