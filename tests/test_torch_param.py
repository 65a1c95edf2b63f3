"""The training path beyond the Cornell box, on the CPU: the fused chunk's
ray-plane route (`gen_rays=False`), `compile_param_renderer` with its
record-walk and wavefront-record routes, and the detached wavefront record
walk (`wavefront.make_record_trace_wave`).

- The routes' names equal the JAX package's `compile_param_renderer(
  engine="pallas")` tags on the same scenes.
- The record-walk route is the fused chunk with `gen_rays=False`: their
  primals are equal bit for bit, their gradients within rtol 2e-4, atol
  1e-7 (the rule of tests/test_torch_diff.py).
- The wavefront-record primal equals the forward wavefront's on the same
  chunk seed, within rtol 1e-4, atol 1e-5: the same rays, hits and
  scatter draws, with the radiance summed as the shade's product chain
  instead of in the bounce loop (JAX tests/test_diff_wavefront.py:54, :72).
- Its gradients, with and without russian roulette, match central finite
  differences of the same deterministic chunk (rel 5e-2, abs 2e-2: JAX
  tests/test_diff_wavefront.py:89, :116).
"""

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.core.config import RenderSettings as JSettings
from raytracing_gpu_tpu.engine.render import (
    compile_param_renderer as jax_param_renderer)
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu_torch import Camera, RenderSettings, SceneBuilder
from raytracing_gpu_tpu_torch.engine import diff, fused_diff, render
from raytracing_gpu_tpu_torch.engine.wavefront import (
    compile_wavefront_renderer)
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.scene.builder import BLACK

torch.set_num_threads(1)

SMALL = dict(image_width=24, spp_per_chunk=2, num_chunks=1, max_depth=3,
             ray_batch=256)
TRAINING_SCENES = ("two_spheres", "two_perlin_spheres", "big_scene1",
                   "triangles", "mesh")


def _scene(name):
    return (tscenes.backpack_standin((16, 16)) if name == "mesh"
            else tscenes.get(name))


def _settings(sd, **kw):
    return RenderSettings(aspect_ratio=sd.aspect, **{**SMALL, **kw})


@pytest.mark.parametrize("name,engine", [
    ("cornell_box", "pallas"), ("two_spheres", "pallas"),
    ("two_perlin_spheres", "pallas"), ("big_scene1", "pallas"),
    ("triangles", "pallas"), ("triangles", "wavefront")])
def test_engine_names_equal_jax(name, engine):
    jsd, tsd = jscenes.get(name), tscenes.get(name)
    kw = dict(image_width=16, aspect_ratio=jsd.aspect, spp_per_chunk=1,
              num_chunks=1, max_depth=2, ray_batch=64)
    want = jax_param_renderer(jsd.scene, jsd.camera, JSettings(**kw),
                              engine=engine).engine_name
    got = render.compile_param_renderer(
        tsd.scene, tsd.camera, RenderSettings(**kw),
        engine="auto" if engine == "pallas" else engine,
        device="cpu").engine_name
    assert got == want == ("wavefront-record" if engine == "wavefront"
                           else "record-walk")


def test_backpack_takes_the_wavefront_record_route():
    sd = tscenes.get("backpack")
    st = _settings(sd, image_width=8, spp_per_chunk=1, max_depth=1,
                   ray_batch=40)
    chunk = render.compile_param_renderer(sd.scene, sd.camera, st,
                                          device="cpu")
    assert chunk.engine_name == "wavefront-record"  # as JAX routes it


def test_record_walk_refuses_russian_roulette():
    sd = tscenes.get("cornell_box")
    with pytest.raises(ValueError, match="russian roulette"):
        render.compile_param_renderer(sd.scene, sd.camera,
                                      _settings(sd, rr_start=1), device="cpu")
    with pytest.raises(ValueError, match="russian roulette"):
        render.compile_param_renderer(sd.scene, sd.camera,
                                      _settings(sd, rr_start=1),
                                      engine="xla", device="cpu")
    with pytest.raises(ValueError, match="debug_stats"):
        render.compile_param_renderer(sd.scene, sd.camera, _settings(sd),
                                      debug_stats=True, device="cpu")


@pytest.mark.parametrize("name", ["cornell_box", "two_spheres",
                                  "big_scene1"])
def test_record_walk_equals_fused_ray_plane_chunk(name):
    sd = tscenes.get(name)
    st = _settings(sd)
    base = 90210 + len(name)
    params = diff.get_params(sd.scene, "cpu")
    fused = fused_diff.compile_fused_param_renderer(
        sd.scene, sd.camera, st, gen_rays=False, device="cpu")
    walk = render.compile_param_renderer(sd.scene, sd.camera, st,
                                         device="cpu")
    assert walk.engine_name == "record-walk"
    target = torch.full_like(fused(params, base), 0.25)
    f_loss, f_grads = diff.value_and_grad(params, lambda p: fused(p, base),
                                          target)
    w_loss, w_grads = diff.value_and_grad(params, lambda p: walk(p, base),
                                          target)
    assert torch.equal(fused(params, base), walk(params, base).detach())
    assert float(f_loss) == float(w_loss)
    for k in diff.PARAM_KEYS:
        np.testing.assert_allclose(f_grads[k].numpy(), w_grads[k].numpy(),
                                   rtol=2e-4, atol=1e-7, err_msg=k)
    assert float(f_grads["tex_c1"].abs().max()) > 0.0


@pytest.mark.parametrize("name", TRAINING_SCENES)
def test_training_entries_take_the_scene(name):
    sd = _scene(name)
    st = _settings(sd)
    params = diff.get_params(sd.scene, "cpu")
    outs = []
    for chunk in (fused_diff.compile_fused_param_renderer(
                      sd.scene, sd.camera, st, gen_rays=True, device="cpu"),
                  fused_diff.compile_fused_param_renderer(
                      sd.scene, sd.camera, st, gen_rays=False, device="cpu"),
                  render.compile_param_renderer(sd.scene, sd.camera, st,
                                                device="cpu")):
        out = chunk(params, 5)
        _, grads = diff.value_and_grad(params, lambda p: chunk(p, 5),
                                       torch.full_like(out, 0.25))
        assert tuple(out.shape) == (render._grid_geometry(st)[3], 3)
        assert torch.isfinite(out).all() and float(out.sum()) > 0.0
        assert all(torch.isfinite(g).all() for g in grads.values())
        outs.append(out.detach()[:st.num_pixels].mean(0))
    # three estimators of one image: the chunk means stay close
    assert torch.allclose(outs[0], outs[1], rtol=0.25)


def _mini_cornell():
    """The mini Cornell box of JAX tests/test_diff_wavefront.py."""
    b = SceneBuilder(background=BLACK)
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light((15.0, 15.0, 15.0))
    b.rect("yz", 0, 555, 0, 555, 555, green)
    b.rect("yz", 0, 555, 0, 555, 0, red)
    b.rect("xz", 213, 343, 227, 332, 554, light)
    b.rect("xz", 0, 555, 0, 555, 0, white)
    b.rect("xz", 0, 555, 0, 555, 555, white)
    b.rect("xy", 0, 555, 0, 555, 555, white)
    b.box((0, 0, 0), (165, 330, 165), white, rotate_y=15,
          translate=(265, 0, 295))
    cam = Camera.make((278, 278, -800), (278, 278, 0), (0, 1, 0), 40, 1.0,
                      0.0, 10.0)
    return b.build(), cam


@pytest.mark.parametrize("rr_start,depth", [(0, 4), (2, 8)])
def test_wavefront_record_primal_matches_forward_wavefront(rr_start, depth):
    sd = tscenes.backpack_standin((16, 16))
    st = RenderSettings(image_width=32, aspect_ratio=sd.aspect,
                        spp_per_chunk=2, num_chunks=1, max_depth=depth,
                        ray_batch=288, rr_start=rr_start)
    chunk = render.compile_param_renderer(sd.scene, sd.camera, st,
                                          engine="wavefront", device="cpu",
                                          debug_stats=True)
    assert chunk.engine_name == "wavefront-record"
    primal, stats = chunk(diff.get_params(sd.scene, "cpu"), 6)
    fwd, fstats = compile_wavefront_renderer(
        sd.scene, sd.camera, st, debug_stats=True, device="cpu")(6)
    n = st.num_pixels
    np.testing.assert_allclose(primal[:n].numpy(), fwd[:n].numpy(),
                               rtol=1e-4, atol=1e-5)
    # the same paths: as many bounces (hit launches on a card) as the
    # forward wavefront traces
    assert stats["iterations"] == fstats["iterations"] > 2 * st.spp_per_chunk


@pytest.mark.parametrize("rr_start,depth,checks", [
    (0, 4, [(0, 0), (2, 1), (3, 2)]), (2, 6, [(0, 0), (3, 2)])])
def test_wavefront_record_grads_match_finite_differences(rr_start, depth,
                                                         checks):
    scene, cam = _mini_cornell()
    st = RenderSettings(image_width=24, aspect_ratio=1.0, spp_per_chunk=4,
                        num_chunks=1, max_depth=depth, ray_batch=24 * 24,
                        rr_start=rr_start)
    chunk = render.compile_param_renderer(scene, cam, st, engine="wavefront",
                                          device="cpu")
    params = diff.get_params(scene, "cpu")
    npix, base = st.num_pixels, 42 + rr_start

    def loss(p):
        return chunk(p, base)[:npix].mean()

    _, grads = diff.value_and_grad(params, loss, 0.0,
                                   loss=lambda img, _t: img)
    eps = 2e-3
    # tex ids: 0 red wall, 1 white, 2 green, 3 light (SceneBuilder order)
    for idx in checks:
        plus = {k: v.clone() for k, v in params.items()}
        minus = {k: v.clone() for k, v in params.items()}
        plus["tex_c1"][idx] += eps
        minus["tex_c1"][idx] -= eps
        fd = (float(loss(plus)) - float(loss(minus))) / (2 * eps)
        ad = float(grads["tex_c1"][idx])
        assert ad == pytest.approx(fd, rel=5e-2, abs=2e-2), (idx, ad, fd)
