"""The perlin textures in the torch shade, on the CPU: noise, turbulence and
marble in `scene/textures.py` `eval_texture`, which the wavefront routes
and the training shade evaluate in torch.

- `eval_texture` and `materials.shade` against the JAX package's on the
  same numpy-seeded hit points and texture tables: atol 1e-5 (the same
  float32 hash-gradient noise, `scene/perlin.py`; torch's and XLA's sin
  differ by an ulp).
- A sphere-BVH scene on a noise-textured ground (`perlin_field`: 70
  spheres of radius 0.2, more than 64, so a BVH) takes the regen route at
  16 spp a chunk and depth 8, as the JAX package routes it, and its regen
  chunk agrees with the pinned JAX regen chunk (`perlin_regen.npz`,
  `tools/make_torch_goldens.py`) statistically: per channel, the mean
  per-pixel difference within 4 standard errors (tests/test_torch_regen.py;
  the random streams differ).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.core.camera import Camera as JCamera
from raytracing_gpu_tpu.core.config import RenderSettings as JSettings
from raytracing_gpu_tpu.engine.render import compile_renderer as jcompile
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.scene import materials as jmaterials
from raytracing_gpu_tpu.scene import textures as jtextures
from raytracing_gpu_tpu.scene.builder import SceneBuilder as JaxBuilder
from raytracing_gpu_tpu_torch import RenderSettings, compile_renderer
from raytracing_gpu_tpu_torch.convert import (camera_from_numpy,
                                             scene_from_numpy)
from raytracing_gpu_tpu_torch.engine import diff
from raytracing_gpu_tpu_torch.engine.wavefront import compile_regen_renderer
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.scene import materials, textures
from raytracing_gpu_tpu_torch.scene import types as st

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
Z_LIMIT = 4.0


def _tree(obj):
    """A JAX scene/camera pytree as nested dicts of numpy leaves."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, bool):
        return obj
    return np.asarray(obj)


def _tables(seed: int, n: int = 24):
    """Random texture tables of every ported kind and hits against them."""
    rng = np.random.default_rng(seed)
    kind = rng.choice([st.TEX_SOLID, st.TEX_CHECKER, st.TEX_NOISE,
                       st.TEX_TURB, st.TEX_MARBLE], n).astype(np.int32)
    kind[:5] = [st.TEX_SOLID, st.TEX_CHECKER, st.TEX_NOISE, st.TEX_TURB,
                st.TEX_MARBLE]
    texs = dict(kind=kind, c1=rng.random((n, 3)).astype(np.float32),
                c2=rng.random((n, 3)).astype(np.float32),
                scale=rng.uniform(0.5, 12.0, n).astype(np.float32),
                image_id=np.full(n, -1, np.int32))
    m = 4096
    hits = dict(tex_id=rng.integers(0, n, m).astype(np.int32),
                u=rng.random(m).astype(np.float32),
                v=rng.random(m).astype(np.float32),
                p=rng.uniform(-30.0, 30.0, (m, 3)).astype(np.float32))
    return texs, hits


def _with_textures(texs, kinds=None):
    jsc = jscenes.get("cornell_box").scene
    tsc = tscenes.get("cornell_box").scene
    jsc = jsc.replace(textures=jsc.textures.replace(
        **{k: jnp.asarray(v) for k, v in texs.items()}))
    tsc = dataclasses.replace(tsc, textures=st.Textures(**texs))
    if kinds is not None:  # materials bound to every texture, of `kinds`
        n = len(texs["kind"])
        mats = dict(kind=np.asarray(kinds, np.int32),
                    tex_id=np.arange(n, dtype=np.int32),
                    fuzz=np.zeros(n, np.float32),
                    ir=np.full(n, 1.5, np.float32))
        jsc = jsc.replace(materials=jsc.materials.replace(
            **{k: jnp.asarray(v) for k, v in mats.items()}))
        tsc = dataclasses.replace(tsc, materials=st.Materials(**mats))
    return jsc, tsc


@pytest.mark.parametrize("seed", [91, 92])
def test_eval_texture_matches_jax(seed):
    texs, hits = _tables(seed)
    jsc, tsc = _with_textures(texs)
    got = textures.eval_texture(tsc, diff.get_params(tsc, "cpu"),
                                *(torch.from_numpy(hits[k])
                                  for k in ("tex_id", "u", "v", "p")))
    want = jtextures.eval_texture(jsc, *(jnp.asarray(hits[k])
                                         for k in ("tex_id", "u", "v", "p")))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    kind = texs["kind"][hits["tex_id"]]
    for k in (st.TEX_NOISE, st.TEX_TURB, st.TEX_MARBLE):  # gray, in [0, 1]
        g = got.numpy()[kind == k]
        assert len(g) and (g[:, 0] == g[:, 2]).all()
        assert g.min() >= 0.0 and g.max() <= 1.0 + 1e-6


def test_shade_with_perlin_matches_jax():
    texs, hits = _tables(93)
    n = len(texs["kind"])
    kinds = np.resize([st.LAMBERTIAN, st.DIFFUSE_LIGHT, st.DIELECTRIC,
                       st.METAL], n)
    jsc, tsc = _with_textures(texs, kinds)
    args = [hits["tex_id"], hits["u"], hits["v"], hits["p"]]
    params = diff.get_params(tsc, "cpu")
    assert materials._fast_shade(tsc, params,
                                 torch.from_numpy(args[0]),
                                 torch.from_numpy(args[3])) is None
    got = materials.shade(tsc, params, *map(torch.from_numpy, args))
    want = jmaterials.shade(jsc, *map(jnp.asarray, args))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def perlin_field(builder_cls, camera_cls):
    """tools/make_torch_goldens.py's `perlin_field`: 70 spheres of radius
    0.2 on a noise(4.0) ground sphere, under a 16:9 camera."""
    b = builder_cls()
    b.sphere((0, -1000, 0), 1000, b.lambertian(b.noise(4.0)))
    for i in range(70):
        x, z = i % 10 - 4.5, i // 10 - 3.0
        b.sphere((0.8 * x, 0.2, 0.8 * z), 0.2,
                 b.lambertian((0.1 + 0.012 * i, 0.5, 0.9 - 0.01 * i)))
    cam = camera_cls.make((0, 3, 7), (0, 0, 0), (0, 1, 0), 40.0, 16 / 9,
                          0.0, 10.0, 0.0, 1.0)
    return b.build(), cam, 16 / 9


def test_perlin_field_regen_matches_jax_golden():
    g = np.load(os.path.join(DATA, "perlin_regen.npz"))
    jscene, jcam, aspect = perlin_field(JaxBuilder, JCamera)
    scene = scene_from_numpy(_tree(jscene._host_np))
    cam = camera_from_numpy(_tree(jcam))
    kw = dict(image_width=int(g["image_width"]), aspect_ratio=aspect,
              spp_per_chunk=int(g["spp_per_chunk"]), num_chunks=1,
              max_depth=int(g["max_depth"]), ray_batch=int(g["ray_batch"]))
    settings = RenderSettings(**kw)
    # the JAX package routes it to regen too (its bake: a sphere BVH)
    assert str(g["engine"]) == "regen"
    assert compile_renderer(scene, cam, settings,
                            device="cpu").engine_name == "regen"
    assert jcompile(jscene, jcam, JSettings(**kw),
                    engine="pallas").engine_name == "regen"
    sums, stats = compile_regen_renderer(scene, cam, settings,
                                         debug_stats=True, device="cpu")(77)
    npix, spp = settings.num_pixels, settings.spp_per_chunk
    a = sums.numpy()[:npix] / spp
    b = g["sums"][:npix] / spp
    assert np.isfinite(a).all() and stats["stream"] == int(g["stream"])
    diff_ = (a - b).astype(np.float64)
    z = diff_.mean(0) / (diff_.std(0, ddof=1) / np.sqrt(npix))
    assert (np.abs(z) < Z_LIMIT).all(), z
