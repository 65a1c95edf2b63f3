"""The port's pure-torch "xla" engine against the JAX package's, on the CPU.

- `accel.traverse`: `traverse_spheres` on big_scene1 and
  `traverse_triangles` on `triangles` (both packages' BVH builders over its
  four triangles, one a leaf) and on the image mesh probe (512 triangles
  under the builders' own BVHs), on 4,096 camera rays: the index and hit on every
  lane, t within 5e-3 (`cuda_trace.HIT_LIMITS["p"]`; XLA on the CPU
  contracts the sphere quadratic's multiply-adds into FMAs, which its
  cancellation turns into up to ~1e-3 of t) and >= 99% of hit lanes within
  2e-3.
- `engine.intersect.closest_hit` with the JAX package's own media draws on
  cornell_smoke, big_scene1, `triangles` and the `many_media` probe: on
  2,048 camera rays hit and material equal on every lane; after one bounce (the
  rays JAX's own scatter sends on) on >= 99.5% of lanes, as
  tests/test_torch_hit.py allows; p, normal, u and v of the lanes that
  agree within `cuda_trace.HIT_LIMITS` (u modulo 1), >= 99% within
  `HIT_CLOSE`.
- `engine.integrator.trace` with the JAX draws of every bounce
  (`fold(key, depth)`, `split`, the media's and the scatter's splits, the
  roulette's `fold(kb, 0x5252)`) on cornell_smoke and `first`, with and
  without russian roulette, 1,024 rays at depth 3: the golden rule, >= 99%
  of rays within atol 1e-3 * max, and channel means within 3e-3 relative.
- `trace_diff`'s gradients of an L2 loss against JAX's on a small Cornell
  render: rtol 2e-4, atol 1e-7.
- The routes: `engine="xla"` tags "xla"; the `many_media` probe goes from
  "auto" to "xla" and renders; every registered scene keeps its route; no
  new module imports JAX.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.accel import bvh as jbvh
from raytracing_gpu_tpu.accel import traverse as jtrav
from raytracing_gpu_tpu.core import rng as jrng
from raytracing_gpu_tpu.core.camera import Camera as JCamera
from raytracing_gpu_tpu.engine import diff as jdiff
from raytracing_gpu_tpu.engine import integrator as jint
from raytracing_gpu_tpu.engine import intersect as jhit
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.scene.builder import SceneBuilder as JBuilder
from raytracing_gpu_tpu_torch import RenderSettings
from raytracing_gpu_tpu_torch.accel import bvh as tbvh
from raytracing_gpu_tpu_torch.accel import traverse as ttrav
from raytracing_gpu_tpu_torch.core.camera import Camera as TCamera
from raytracing_gpu_tpu_torch.engine import diff as tdiff
from raytracing_gpu_tpu_torch.engine import integrator as tint
from raytracing_gpu_tpu_torch.engine import intersect as thit
from raytracing_gpu_tpu_torch.engine import render
from raytracing_gpu_tpu_torch.models import probes
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct
from raytracing_gpu_tpu_torch.scene import materials as tmat
from raytracing_gpu_tpu_torch.scene.builder import SceneBuilder as TBuilder

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096
T_MIN = 0.001


def T(x):
    return torch.from_numpy(np.array(x))


def _pair(name):
    """(JAX scene, JAX camera, port scene): a registered scene or a probe
    built by the same calls in both packages."""
    if name == "many_media":
        js, jc, _ = probes.many_media(JBuilder, JCamera)
        ts, _, _ = probes.many_media(TBuilder, TCamera)
        return js, jc, ts
    if name == "image_mesh":
        js, jc, _ = probes.image_mesh(JBuilder, JCamera)
        ts, _, _ = probes.image_mesh(TBuilder, TCamera)
        return js, jc, ts
    jsd = jscenes.get(name)
    return jsd.scene, jsd.camera, tscenes.get(name).scene


def _camera_rays(camera, n, seed=1):
    rng = np.random.default_rng(seed)
    u = jnp.asarray(rng.random(n, np.float32))
    v = jnp.asarray(rng.random(n, np.float32))
    return camera.get_rays(jax.random.PRNGKey(seed), u, v)


def _host(scene):
    return getattr(scene, "_host_np", scene)


def _media_draws(key, host, n):
    """`_media_candidate`'s uniforms of `key`: the sphere table's from the
    first half of its split, the box table's from the second."""
    k_sp, k_bx = jax.random.split(key)
    return thit.MediaDraws(
        T(jrng.uniform(k_sp, (n, host.spheres.radius.shape[0])))
        if host.has_sphere_media else None,
        T(jrng.uniform(k_bx, (n, host.boxes.mat_id.shape[0])))
        if host.has_box_media else None)


def jax_draws(key, host, n, rr):
    """`integrator.trace`'s draws of every bounce, from JAX's keys."""
    def draw(depth):
        kb = jrng.fold(key, depth)
        k_hit, k_scat = jax.random.split(kb)
        k_unit, k_sphere, k_iso, k_refl = jax.random.split(k_scat, 4)
        scatter = tmat.ScatterDraws(
            T(jrng.unit_vector(k_unit, (n,))),
            T(jrng.in_unit_sphere(k_sphere, (n,))),
            T(jrng.in_unit_sphere(k_iso, (n,))), T(jrng.uniform(k_refl, (n,))))
        return tint.BounceDraws(
            _media_draws(k_hit, host, n), scatter,
            T(jrng.uniform(jrng.fold(kb, 0x5252), (n,))) if rr else None)

    return draw


def _assert_t_close(got_t, want_t, hit):
    err = np.abs(got_t - want_t)[hit]
    assert err.max() <= ct.HIT_LIMITS["p"], err.max()
    assert (err <= ct.HIT_CLOSE).mean() >= 0.99


# --------------------------------------------------------------------------
# traversal
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def big():
    return _pair("big_scene1")


def test_traverse_spheres_matches_jax(big):
    js, jc, ts = big
    o, d, tm = _camera_rays(jc, N)
    want_t, want_i = jax.jit(lambda o, d, tm: jtrav.traverse_spheres(
        js, o, d, tm, T_MIN))(o, d, tm)
    geom = thit.geometry(ts, "cpu")
    got_t, got_i = ttrav.traverse_spheres(geom.spheres, geom.sphere_bvh,
                                          T(o), T(d), T(tm), T_MIN)
    want_t, got_t = np.asarray(want_t), got_t.numpy()
    hit = want_t < 1e29
    assert hit.sum() > 2500
    np.testing.assert_array_equal(got_t < 1e29, hit)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    _assert_t_close(got_t, want_t, hit)


@pytest.mark.parametrize("name", ["triangles", "image_mesh"])
def test_traverse_triangles_matches_jax(name):
    js, jc, ts = _pair(name)
    if name == "triangles":
        # four triangles, below the builders' threshold: both packages'
        # BVH over them, a triangle a leaf
        cols = {c: np.asarray(getattr(ts.triangles, c))[
            ts.triangles.active] for c in ("v0", "e1", "e2")}
        js = js.replace(tri_bvh=jax.tree.map(
            jnp.asarray, jbvh.build_triangle_bvh(cols, leaf_size=1)))
        ts = dataclasses.replace(ts, tri_bvh=tbvh.build_triangle_bvh(
            cols, leaf_size=1))
    assert ts.tri_bvh is not None and len(ts.tri_bvh.node_min) > 1
    for f in ("node_min", "node_max", "hit_link", "miss_link", "leaf_prims"):
        np.testing.assert_array_equal(getattr(ts.tri_bvh, f),
                                      np.asarray(getattr(js.tri_bvh, f)))
    o, d, _ = _camera_rays(jc, N)
    want_t, want_i = jax.jit(lambda o, d: jtrav.traverse_triangles(
        js, o, d, T_MIN))(o, d)
    geom = thit.geometry(ts, "cpu")
    got_t, got_i = ttrav.traverse_triangles(geom.triangles, geom.tri_bvh,
                                            T(o), T(d), T_MIN)
    want_t, got_t = np.asarray(want_t), got_t.numpy()
    hit = want_t < 1e29
    assert hit.sum() > 200
    np.testing.assert_array_equal(got_t < 1e29, hit)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    _assert_t_close(got_t, want_t, hit)


# --------------------------------------------------------------------------
# closest hit
# --------------------------------------------------------------------------


def _unit_vectors(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _assert_records_match(got, want, d, lane_floor):
    """hit equal on every lane; the material on >= `lane_floor` of the hit
    lanes; the floats of the lanes that agree by HIT_LIMITS, >= 99% of
    them within HIT_CLOSE.  t takes p's limits, and p = o + t d takes them
    times |d|: big_scene1's camera rays are ~10.4 long, and on its ground
    sphere (radius 1000: one ulp of r * r is 0.06) XLA's contracted
    quadratic moves t by up to 5.2e-4."""
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    same = hit & (got.mat_id.numpy() == np.asarray(want.mat_id))
    assert same.sum() >= lane_floor * hit.sum(), (same.sum(), hit.sum())
    close = np.ones(int(same.sum()), bool)
    scale = np.maximum(np.linalg.norm(np.asarray(d, np.float64), axis=1),
                       1.0)[same]
    for f, limit in (("t", ct.HIT_LIMITS["p"]),) + tuple(
            ct.HIT_LIMITS.items()):
        err = np.abs(getattr(got, f).numpy().astype(np.float64)
                     - np.asarray(getattr(want, f), np.float64))[same]
        if f == "u":
            err = np.minimum(err, 1.0 - err)
        if err.ndim == 2:
            err = err.max(-1)
        if f == "p":
            err = err / scale
        assert err.max() <= limit, (f, err.max())
        close &= err <= ct.HIT_CLOSE
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_array_equal(got.front_face.numpy()[same],
                                  np.asarray(want.front_face)[same])


@pytest.mark.parametrize("name", ["cornell_smoke", "big_scene1", "triangles",
                                  "many_media"])
def test_closest_hit_matches_jax(name):
    js, jc, ts = _pair(name)
    host = _host(js)
    o, d, tm = _camera_rays(jc, N // 2)
    key0, key1 = jax.random.split(jax.random.PRNGKey(5))
    hit_fn = jax.jit(lambda o, d, tm, k: jhit.closest_hit(js, o, d, tm, k))
    geom = thit.geometry(ts, "cpu")
    want = hit_fn(o, d, tm, key0)
    got = thit.closest_hit(ts, T(o), T(d), T(tm),
                           draws=_media_draws(key0, host, N // 2), geom=geom)
    _assert_records_match(got, want, d, 1.0)
    if name in ("cornell_smoke", "many_media"):
        assert (np.asarray(want.mat_id)[np.asarray(want.hit)]
                >= len(host.materials.kind) - 20).any()  # media events
    # one bounce: from each hit along its normal plus a unit vector drawn
    # by numpy (a lambertian bounce); a lane that missed keeps its ray
    hit = np.asarray(want.hit)[:, None]
    bounce = np.asarray(want.normal) + _unit_vectors(len(hit), 2)
    o1 = jnp.asarray(np.where(hit, np.asarray(want.p), np.asarray(o)))
    d1 = jnp.asarray(np.where(hit, bounce, np.asarray(d)))
    want1 = hit_fn(o1, d1, tm, key1)
    got1 = thit.closest_hit(ts, T(o1), T(d1), T(tm),
                            draws=_media_draws(key1, host, N // 2), geom=geom)
    _assert_records_match(got1, want1, d1, 0.995)


# --------------------------------------------------------------------------
# the path tracer
# --------------------------------------------------------------------------


def _assert_golden_rule(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    within = (np.abs(got - want) <= 1e-3 * np.abs(want).max()).all(-1).mean()
    assert within >= 0.99, within
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=3e-3)


@pytest.mark.parametrize("rr_start", [0, 1])
@pytest.mark.parametrize("name", ["cornell_smoke", "first"])
def test_trace_matches_jax_with_its_draws(name, rr_start):
    js, jc, ts = _pair(name)
    n = 1024
    o, d, tm = _camera_rays(jc, n, seed=3)
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda o, d, tm, k: jint.trace(
        js, o, d, tm, k, max_depth=3, rr_start=rr_start))(o, d, tm, key)
    got = tint.trace(ts, T(o), T(d), T(tm),
                     draws=jax_draws(key, _host(js), n, rr_start > 0),
                     max_depth=3, rr_start=rr_start)
    _assert_golden_rule(got.numpy(), want)
    assert float(got.mean()) > 0.0


def test_trace_diff_gradients_match_jax():
    js, jc, ts = _pair("cornell_box")
    n = 1024
    o, d, tm = _camera_rays(jc, n, seed=4)
    key = jax.random.PRNGKey(13)
    target = np.random.default_rng(5).random((n, 3)).astype(np.float32)

    def jloss(p):
        rad = jint.trace_diff(jdiff.set_params(js, p), o, d, tm, key,
                              max_depth=3)
        return jnp.mean((rad - target) ** 2)

    want_v, want_g = jax.jit(jax.value_and_grad(jloss))(jdiff.get_params(js))
    params = tdiff.get_params(ts, "cpu")
    draw = jax_draws(key, _host(js), n, False)
    value, grads = tdiff.value_and_grad(
        params, lambda p: tint.trace_diff(ts, p, T(o), T(d), T(tm),
                                          draws=draw, max_depth=3),
        torch.from_numpy(target))
    np.testing.assert_allclose(float(value), float(want_v), rtol=2e-4)
    for k in ("tex_c1", "tex_c2"):
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(want_g[k]),
                                   rtol=2e-4, atol=1e-7, err_msg=k)
    assert np.abs(grads["tex_c1"].numpy()).max() > 1e-4
    with pytest.raises(ValueError, match="russian roulette"):
        tint.trace_diff(ts, params, T(o), T(d), T(tm), draws=draw,
                        max_depth=3, rr_start=1)


def test_trace_draws_from_a_generator_and_ends_when_all_paths_do():
    sd = tscenes.get("cornell_smoke")
    o, d, tm = (T(x) for x in _camera_rays(jscenes.get("cornell_smoke")
                                           .camera, 256, seed=6))
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = tint.trace(sd.scene, o, d, tm, gen(), max_depth=4)
    b = tint.trace(sd.scene, o, d, tm, gen(), max_depth=4)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    with pytest.raises(ValueError, match="Generator"):
        tint.trace(sd.scene, o, d, tm, max_depth=2)
    # black background and a light: every path ends, and the walk records
    # zeros past the last live bounce, as JAX's dead bounces do
    data = tint.trace_bounces(sd.scene, o, d, tm, gen(), max_depth=200)
    assert data.mat_id.shape == (200, 256)
    last = int(np.nonzero((data.hit | data.miss).any(1).numpy())[0].max())
    assert last < 199 and not data.hit[last + 1:].any()


# --------------------------------------------------------------------------
# routes
# --------------------------------------------------------------------------


def _settings(**kw):
    base = dict(image_width=8, aspect_ratio=1.0, spp_per_chunk=1,
                num_chunks=1, max_depth=2, ray_batch=64)
    return RenderSettings(**{**base, **kw})


def test_xla_engine_is_taken_by_name_or_by_an_unported_feature():
    sd = tscenes.get("cornell_box")
    st = _settings()
    chunk = render.compile_renderer(sd.scene, sd.camera, st, "cpu",
                                    engine="xla")
    assert chunk.engine_name == "xla"
    assert tuple(chunk(7).shape) == (64, 3)
    pchunk = render.compile_param_renderer(sd.scene, sd.camera, st,
                                           engine="xla", device="cpu")
    assert pchunk.engine_name == "xla"
    assert bool(torch.isfinite(pchunk(tdiff.get_params(sd.scene, "cpu"),
                                      7)).all())
    with pytest.raises(ValueError, match="engine"):
        render.compile_renderer(sd.scene, sd.camera, st, "cpu",
                                engine="cuda")
    scene, cam, _ = probes.many_media(TBuilder, TCamera)
    assert ct.unported_feature(scene) == "20 constant media (more than 16)"
    chunk = render.compile_renderer(scene, cam, st, "cpu")
    assert chunk.engine_name == "xla"
    sums = chunk(5)
    assert bool(torch.isfinite(sums).all()) and float(sums.sum()) > 0.0
    assert render.compile_param_renderer(scene, cam, st,
                                         device="cpu").engine_name == "xla"
    with pytest.raises(NotImplementedError, match="constant media"):
        render.compile_renderer(scene, cam, st, "cpu", engine="pallas")


def test_every_registered_scene_keeps_its_route():
    """"auto" takes "xla" only where a kernel refuses a feature, which no
    registered scene has: each keeps the kernels' route, which
    tests/test_torch_regen.py and tests/test_torch_triangles.py hold to
    the JAX package's engine names."""
    for name in tscenes.names():
        scene = tscenes.get(name).scene
        assert ct.unported_feature(scene) is None, name
        assert not render._xla_wanted(scene, "auto", render.ENGINES), name
        assert render._xla_wanted(scene, "xla", render.ENGINES), name
    sd = tscenes.get("big_scene1")
    for st in (_settings(aspect_ratio=sd.aspect),
               _settings(aspect_ratio=sd.aspect, spp_per_chunk=16,
                         max_depth=16)):
        chunk = render.compile_renderer(sd.scene, sd.camera, st, "cpu")
        assert chunk.engine_name == render.route(
            ct.Tracer(sd.scene, "cpu"), st) in ("megakernel", "regen")


def test_new_modules_never_import_jax():
    mods = ("raytracing_gpu_tpu_torch.accel.traverse",
            "raytracing_gpu_tpu_torch.engine.intersect",
            "raytracing_gpu_tpu_torch.engine.integrator",
            "raytracing_gpu_tpu_torch.utils.checkpoint",
            "raytracing_gpu_tpu_torch.models.probes", "bench_all_torch")
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax'):\n"
            "    sys.modules[m] = None\n"
            f"import importlib\nfor m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(m.startswith('raytracing_gpu_tpu.') or "
            "m == 'raytracing_gpu_tpu' for m in sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env={**os.environ, "PYTHONPATH": ROOT}, timeout=120)
    for path in ("bench_all_torch.py", "raytracing_gpu_tpu_torch/accel/"
                 "traverse.py", "raytracing_gpu_tpu_torch/engine/"
                 "intersect.py", "raytracing_gpu_tpu_torch/utils/"
                 "checkpoint.py"):
        text = open(os.path.join(ROOT, path)).read()
        for word in ("import jax", "from jax", "raytracing_gpu_tpu."):
            assert word not in text, (path, word)
