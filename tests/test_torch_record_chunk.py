"""Kernel 1b's record walk of a whole training chunk on the CPU, where
`Tracer.bind_record_chunk` runs `cuda_trace.walk_chunk_reference` (on the
card: one `rt_walk_chunk` launch a group of waves).

- The plain chunk walk equals the per-wave `walk_packed_pixels_reference`
  stacked, bit for bit on every plane, wave and lane, on Cornell (the
  packed plane), `cornell_smoke` (media), `two_perlin_spheres` (hit-point
  planes), big_scene1 (the sphere BVH), `triangles` (the triangle BVH) and
  the image probe of `models/probes.py` (uv planes), 24-32 px wide, 2-3
  spp, depth 3-4, waves of 256 that leave a padded last wave; its work
  counts are those of its planes.
- One chunk's waves match the JAX package's
  `PallasTracer.walk_packed_pixels` (interpret mode) wave by wave under
  the rules of tests/test_torch_record_p.py and
  tests/test_torch_record_uv.py: `record_agreement` (every lane at bounce
  0 whose camera ray is the same on both sides, >= 99% of lanes over all
  bounces; with a lens, torch's and XLA's cos and sin of the lens angle
  differ by an ulp on a few lanes), `p_agreement`'s hit rule and
  `uv_agreement` with the probe's bounce-0 limit (`UV_LIMIT0`).
- `compile_fused_param_renderer(device="cpu")`, which walks the chunk,
  gives the same sums and the same gradients as the fused chunk over the
  per-wave walk, bit for bit, with and without saved planes, and walks
  each group once forward and, without saved planes, once more backward.
  Its agreement with the JAX fused chunk (sums under the forward rule,
  gradients rtol 2e-4, atol 1e-7) is tests/test_torch_diff.py's
  `test_fused_chunk_matches_jax`, whose port side is this chunk walk.
- A chunk split into groups of waves under a small byte budget gives the
  same planes and the same fused chunk as one group.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.core.camera import Camera as JCamera
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu.scene.builder import SceneBuilder as JBuilder
from raytracing_gpu_tpu_torch import Camera, RenderSettings, SceneBuilder
from raytracing_gpu_tpu_torch.engine import diff, fused_diff
from raytracing_gpu_tpu_torch.models import probes
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import build
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct

torch.set_num_threads(1)

BATCH = 256
BASE = 1_618_033_988
# scene, width, spp, depth: 24 x 24 or 32 x 18 = 576 pixels, three waves
# of 256 with the last one padded
PLAIN_CASES = [("cornell_box", 24, 3, 4), ("cornell_smoke", 24, 2, 4),
               ("two_perlin_spheres", 32, 2, 3), ("big_scene1", 32, 2, 3),
               ("triangles", 32, 3, 4), ("image_probe", 24, 2, 3)]


def _scene(name, jax=False):
    """(scene, camera, aspect) of a registered scene or the image probe,
    the port's or the JAX package's."""
    if name == "image_probe":  # a 64-triangle mesh keeps JAX's compile short
        return probes.image_probe(*((JBuilder, JCamera) if jax
                                    else (SceneBuilder, Camera)),
                                  mesh_res=(4, 8))
    sd = (jscenes if jax else tscenes).get(name)
    return sd.scene, sd.camera, sd.aspect


def _shape(width, aspect):
    h = int(width / aspect)
    return h, width, -(-h * width // BATCH)


def _per_wave(bake, cam, h, w, spp, depth, nb, base=BASE):
    """Every wave's `walk_packed_pixels_reference`, stacked per plane."""
    waves = [ct.walk_packed_pixels_reference(
        bake, cam, h, w, bid * BATCH, BATCH, ct.wave_seed(base, s, bid),
        depth) for s in range(spp) for bid in range(nb)]
    return tuple(torch.stack(p) for p in zip(*waves))


@pytest.mark.parametrize("name,width,spp,depth", PLAIN_CASES)
def test_plain_chunk_walk_equals_the_waves(name, width, spp, depth):
    scene, cam, aspect = _scene(name)
    bake = ct.bake_scene(scene)
    h, w, nb = _shape(width, aspect)
    assert nb * BATCH > h * w  # a padded last wave
    counts = {}
    got = ct.walk_chunk_reference(bake, cam, h, w, BASE, spp, BATCH, depth,
                                  counts=counts)
    want = _per_wave(bake, cam, h, w, spp, depth, nb)
    assert len(got) == 1 + 3 * bake.need_p + 2 * bake.need_uv == len(want)
    for g, v in zip(got, want):
        assert tuple(g.shape) == (spp * nb, depth, BATCH)
        assert torch.equal(g, v)
    # planes[s, bid] is wave (s, bid)'s (depth, ray_batch) plane
    s, bid = spp - 1, nb - 1
    assert torch.equal(got[0].view(spp, nb, depth, BATCH)[s, bid],
                       want[0][s * nb + bid])
    words = got[0].to(torch.int64)
    assert counts["live"] == int(((words & (ct.HIT_BIT | ct.MISS_BIT)) != 0)
                                 .sum())
    assert counts["cont"] == int(((words & ct.CONT_BIT) != 0).sum())
    assert counts["live"] > counts["cont"] > 0
    if name == "big_scene1":
        assert counts["nodes"] > 0 and counts["rows"] > 0
    if name in ("triangles", "image_probe"):
        assert counts["tri_nodes"] > 0 and counts["tri_rows"] > 0


def _xla_lens_cos_sin(seed, n):
    """XLA's cos and sin of the lens angle of lanes 0..n-1 of an in-kernel
    camera call with int32 seed `seed` (pallas_trace.py:902-907,
    :1585-1594), beside torch's (`cuda_trace.lens_cos_sin`)."""
    lane = jnp.arange(n, dtype=jnp.uint32)
    base = pt._pcg_hash(lane ^ (jnp.asarray(seed, jnp.int32)
                                .astype(jnp.uint32) * jnp.uint32(0x85EBCA6B)))
    cdraw = base + jnp.uint32(0x7F4A7C15) * jnp.uint32(0x68E31DA4)
    theta = (2.0 * math.pi) * pt._uniform(cdraw, 2)
    return np.stack([np.asarray(jnp.cos(theta)), np.asarray(jnp.sin(theta))])


@pytest.mark.parametrize("name,width", [("two_perlin_spheres", 32),
                                        ("image_probe", 24)])
def test_chunk_waves_match_jax(name, width):
    spp, depth = 2, 3
    scene, cam, aspect = _scene(name)
    jscene, jcam, _ = _scene(name, jax=True)
    h, w, nb = _shape(width, aspect)
    tracer = ct.Tracer(scene, "cpu")
    planes = tracer.bind_record_chunk(cam, h, w, depth, 0.001, BATCH,
                                      spp)(BASE)
    jtr = pt.PallasTracer(jscene)
    assert (jtr.need_p, jtr.need_uv) == (tracer.need_p, tracer.need_uv)
    seeds = [ct.wave_seed(BASE, s, bid) for s in range(spp)
             for bid in range(nb)]
    jwaves = [[np.asarray(x).reshape(depth, -1)[:, :BATCH]
               for x in jtr.walk_packed_pixels(
                   jcam, h, w, (k % nb) * BATCH, BATCH, jnp.int32(seed),
                   max_depth=depth, t_min=0.001)]
              for k, seed in enumerate(seeds)]
    want = np.stack([x[0] for x in jwaves]).astype(np.int32)
    same = None
    if float(cam.lens_radius) != 0.0:
        same = np.stack([(ct.lens_cos_sin(seed, BATCH).numpy()
                          == _xla_lens_cos_sin(seed, BATCH)).all(0)
                         for seed in seeds])
        assert same.mean() >= 0.9, same.mean()
    rec = ct.record_agreement(planes[0], want, same)
    assert rec["first_bounce"] and rec["lane_frac"] >= 0.99, rec
    if tracer.need_p:
        res = ct.p_agreement(planes[0], want, torch.stack(planes[1:4], 1),
                             np.stack([np.stack(x[1:4]) for x in jwaves]))
        assert res["hit_rule"] and res["entries"] > 500, res
    if tracer.need_uv:
        res = ct.uv_agreement(planes[0], want, torch.stack(planes[-2:], 1),
                              np.stack([np.stack(x[-2:]) for x in jwaves]),
                              ct.UV_LIMIT0["image_probe_uv32"])
        assert res["rule"] and res["entries"] > 100, res


def _value_and_grad(chunk, params, base=BASE):
    out = chunk(params, base)
    _, grads = diff.value_and_grad(params, lambda p: chunk(p, base),
                                   torch.full_like(out, 0.25))
    return out.detach(), grads


@pytest.mark.parametrize("name,width,save_planes", [
    ("cornell_box", 24, True), ("cornell_box", 24, False),
    ("two_spheres", 32, True), ("two_spheres", 32, False),
    ("image_probe", 24, None)])
def test_fused_chunk_over_the_chunk_walk_equals_the_waves(name, width,
                                                          save_planes):
    scene, cam, aspect = _scene(name)
    st = RenderSettings(image_width=width, aspect_ratio=aspect,
                        spp_per_chunk=2, num_chunks=1, max_depth=3,
                        ray_batch=BATCH)
    tracer = ct.Tracer(scene, "cpu")
    params = diff.get_params(scene, "cpu")
    chunk = fused_diff.compile_fused_param_renderer(
        scene, cam, st, save_planes=save_planes, device="cpu")
    out, grads = _value_and_grad(chunk, params)
    by_wave = fused_diff.fused_chunk_from_walk(
        scene, tracer.bind_record(cam, st.image_height, width, 3), st,
        save_planes, "cpu")
    want, want_grads = _value_and_grad(by_wave, params)
    assert chunk.save_planes == by_wave.save_planes
    assert torch.equal(out, want) and float(out.sum()) > 0.0
    assert set(grads) == set(want_grads) == set(diff.PARAM_KEYS)
    for k in diff.PARAM_KEYS:
        assert torch.equal(grads[k], want_grads[k]), k
    assert float(grads["tex_c1"].abs().max()) > 0.0
    if tracer.need_uv:
        assert float(grads["atlas_data"].abs().max()) > 0.0


@pytest.mark.parametrize("save_planes,walks", [(True, 1), (False, 2)])
def test_groups_split_the_chunk_and_give_the_same_result(save_planes, walks,
                                                         monkeypatch):
    scene, cam, aspect = _scene("two_perlin_spheres")
    h, w, nb = _shape(32, aspect)
    spp, depth = 2, 3
    tracer = ct.Tracer(scene, "cpu")
    one = tracer.bind_record_chunk(cam, h, w, depth, 0.001, BATCH, spp)
    wave_bytes = 4 * 4 * depth * BATCH  # packed and p: 16 bytes an entry
    monkeypatch.setattr(ct, "RECORD_CHUNK_BYTES", 4 * wave_bytes - 1)
    bound = tracer.bind_record_chunk(cam, h, w, depth, 0.001, BATCH, spp)
    assert bound.nb == one.nb == nb and one.groups == [(0, spp * nb)]
    assert bound.groups == [(0, 3), (3, 3)]
    whole = one(BASE)
    split = [bound(BASE, first, count) for first, count in bound.groups]
    for k, plane in enumerate(whole):
        assert torch.equal(plane, torch.cat([g[k] for g in split]))
    calls = []

    def walk_chunk(base, first, count):
        calls.append((first, count))
        return bound(base, first, count)

    walk_chunk.groups = bound.groups
    st = RenderSettings(image_width=w, aspect_ratio=aspect,
                        spp_per_chunk=spp, num_chunks=1, max_depth=depth,
                        ray_batch=BATCH)
    params = diff.get_params(scene, "cpu")
    chunk = fused_diff.fused_chunk_from_chunk_walk(scene, walk_chunk, st,
                                                   save_planes, "cpu")
    out = chunk(params, BASE)
    calls.clear()
    _, grads = diff.value_and_grad(params, lambda p: chunk(p, BASE),
                                   torch.full_like(out, 0.25))
    assert calls == bound.groups * walks  # forward, and backward without
    want, want_grads = _value_and_grad(fused_diff.fused_chunk_from_walk(
        scene, tracer.bind_record(cam, h, w, depth), st, save_planes,
        "cpu"), params)
    assert torch.equal(out, want)
    for k in diff.PARAM_KEYS:
        assert torch.equal(grads[k], want_grads[k]), k


def test_record_groups_and_the_wrapper_check_their_arguments(monkeypatch):
    assert ct.record_groups(10, 100, 350) == [(0, 3), (3, 3), (6, 3), (9, 1)]
    assert ct.record_groups(3, 100, 50) == [(0, 1), (1, 1), (2, 1)]
    assert ct.record_groups(4, 100, ct.RECORD_CHUNK_BYTES) == [(0, 4)]
    with pytest.raises(ValueError):
        ct.record_groups(0, 100, ct.RECORD_CHUNK_BYTES)

    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load kernels")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    scene, cam, _ = _scene("cornell_box")
    tracer = ct.Tracer(scene, "cpu")
    before = (ct.Tracer.record_launches, ct.Tracer.record_chunk_launches)
    launch = tracer.bind_record_chunk(cam, 24, 24, 2, 0.001, BATCH, 2)
    assert launch.groups == [(0, 6)] and launch.nb == 3
    packed, = launch(7, 4, 2)
    assert tuple(packed.shape) == (2, 2, BATCH)
    assert torch.equal(packed, ct.walk_chunk_reference(
        tracer.bake, cam, 24, 24, 7, 2, BATCH, 2)[0][4:])
    assert (ct.Tracer.record_launches,
            ct.Tracer.record_chunk_launches) == before
    for first, count in ((0, 7), (6, 1), (-1, 2), (2, 0)):
        with pytest.raises(ValueError):
            launch(7, first, count)
    with pytest.raises(ValueError):
        tracer.bind_record_chunk(cam, 24, 24, 2, 0.001, BATCH, 0)
