"""The dense scenes (spheres, media, every material, checker and perlin
albedo, russian roulette) in the port against the JAX package, on the CPU.

- Scene tables equal the JAX builder's host snapshot (`_host_np`) and the
  bake equals `pallas_trace.bake_scene`, exactly.
- `scene/perlin.py` equals the kernel's `_noise3`/`_turb3` exactly.
- `Tracer.trace_pixels` (the plain version) against
  `PallasTracer.trace_pixels` in interpret mode (`sub=8`, one 1,024-lane
  tile), same camera and int32 seed: depth 1 allclose(rtol=1e-5,
  atol=1e-5); depth 3, and the russian-roulette case at depth 4, >= 99% of
  lanes within atol 1e-3 * max and channel means within 1e-3 relative
  (torch's and XLA's sin/cos/log/exp on the CPU differ by an ulp here and
  there, and the perlin and checker arguments reach the thousands).
- Record planes against `PallasTracer.walk_packed_pixels` under the bit
  rule (`cuda_trace.record_agreement`): every lane at bounce 0, >= 99% of
  lanes over all bounces; and the record and forward modes trace the same
  paths (radiance equal bit for bit).
- The pinned goldens `tests/data/torch_port/<scene>_32.npz` (the card's
  reference, `tools/make_torch_goldens.py`): the same depth-3 rule, with
  channel means within 3e-3 relative on these 576-1,024-pixel chunks, where
  one diverging path moves a mean on its own (at most 2.52e-3 over 16 keys
  per scene, `tools/golden_spread.py`).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu.scene.builder import SceneBuilder as JaxBuilder
from raytracing_gpu_tpu_torch import (Camera, RenderSettings, SceneBuilder,
                                     cli, compile_renderer)
from raytracing_gpu_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from raytracing_gpu_tpu_torch.engine import fused_diff
from raytracing_gpu_tpu_torch.engine.diff import get_params
from raytracing_gpu_tpu_torch.engine.integrator import shade_packed
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct
from raytracing_gpu_tpu_torch.scene import perlin
from raytracing_gpu_tpu_torch.scene import types as tst

torch.set_num_threads(1)

SCENES = ("basic", "first", "two_spheres", "two_perlin_spheres",
          "cornell_smoke")
RECORD_SCENES = ("first", "cornell_smoke")
TABLES = sorted(tst.TABLES)
H = W = 32
N = H * W
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")


def _tree(obj):
    """A JAX scene/camera pytree as nested dicts of numpy leaves."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, bool):
        return obj
    return np.asarray(obj)


class _Pair:
    """One scene in both packages, with the JAX tracer built on first use."""

    def __init__(self, name):
        self.jsd, self.tsd = jscenes.get(name), tscenes.get(name)
        self.cam = camera_from_numpy(_tree(self.jsd.camera))
        self._jtr = None

    @property
    def jtr(self):
        if self._jtr is None:
            self._jtr = pt.PallasTracer(self.jsd.scene)
        return self._jtr


@pytest.fixture(scope="module")
def pairs():
    return {name: _Pair(name) for name in SCENES}


def _seed(i):
    return int(np.random.default_rng(131 + i).integers(-2**31, 2**31 - 1))


def assert_matches(got, want, depth, mean_rtol=1e-3):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    if depth <= 1:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    err = np.abs(got - want)
    within = (err <= 1e-3 * np.abs(want).max()).all(-1).mean()
    assert within >= 0.99, within
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=mean_rtol)


# ---------------------------------------------------------------------------
# tables, bake, perlin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("name", SCENES)
def test_tables_equal_jax_host_snapshot(pairs, name, table):
    pair = pairs[name]
    a = getattr(pair.jsd.scene._host_np, table)
    b = getattr(pair.tsd.scene, table)
    for f in dataclasses.fields(b):
        x, y = np.asarray(getattr(a, f.name)), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, (table, f.name)
        np.testing.assert_array_equal(y, x, err_msg=f"{table}.{f.name}")


@pytest.mark.parametrize("name", SCENES)
def test_scene_fields_and_conversion_equal(pairs, name):
    pair = pairs[name]
    host, scene = pair.jsd.scene._host_np, pair.tsd.scene
    np.testing.assert_array_equal(scene.background,
                                  np.asarray(host.background))
    assert scene.has_sphere_media == host.has_sphere_media
    assert scene.has_box_media == host.has_box_media
    assert host.sphere_bvh is None and host.tri_bvh is None
    assert pair.tsd.aspect == pair.jsd.aspect
    converted = scene_from_numpy(_tree(host))
    for table in TABLES:
        for f in dataclasses.fields(getattr(scene, table)):
            np.testing.assert_array_equal(
                getattr(getattr(converted, table), f.name),
                getattr(getattr(scene, table), f.name))  # exact
    for f in dataclasses.fields(pair.cam):
        np.testing.assert_allclose(getattr(pair.tsd.camera, f.name).numpy(),
                                   getattr(pair.cam, f.name).numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=f.name)


@pytest.mark.parametrize("name", SCENES)
def test_bake_equals_jax(pairs, name):
    pair = pairs[name]
    jb, tb = pt.bake_scene(pair.jsd.scene), ct.bake_scene(pair.tsd.scene)
    for mine, theirs in ((tb.rects, jb.rects), (tb.boxes, jb.boxes),
                         (tb.sphere_media, jb.sphere_media),
                         (tb.box_media, jb.box_media)):
        assert len(mine) == len(theirs)
        for m, t in zip(mine, theirs):
            assert m == {k: t[k] for k in m}  # exact
    assert tb.sphere_table.dtype == np.float32
    np.testing.assert_array_equal(tb.sphere_table, jb.sphere_table)
    assert tb.background == jb.background
    assert len(jb.sph_nodes) == 0 and len(jb.tri_table) == 0
    assert ct.supports_forward(pair.tsd.scene)
    # every kernel record carries the winner's shading block
    n_prims = (len(tb.rects) + len(tb.boxes) + len(tb.sphere_table)
               + len(tb.sphere_media) + len(tb.box_media))
    shading = tb.shading_table()
    assert shading.shape == (1 + n_prims, ct.SH_COLS)
    np.testing.assert_array_equal(
        shading[1 + len(tb.rects) + len(tb.boxes):][:len(tb.sphere_table)],
        jb.sphere_table[:, ct.SPHERE_SH:ct.SPHERE_SH + ct.SH_COLS])


def test_media_records_round_the_jax_constants_once(pairs):
    tb = ct.bake_scene(pairs["cornell_smoke"].tsd.scene)
    media = tb.media_table()
    assert media.shape == (2, ct.MEDIUM_COLS) and not tb.sphere_media
    for row, m in zip(media, tb.box_media):
        assert row[0] == np.float32(m["nid"]) == np.float32(-100.0)
        np.testing.assert_array_equal(row[1:12], np.float32(
            (*m["bmin"], *m["bmax"], m["cos"], m["sin"], *m["off"])))
    b = SceneBuilder()
    b.sphere_medium((1, 2, 3), 0.7, 0.2, (0.5, 0.5, 0.5))
    row = ct.bake_scene(b.build()).media_table()[0]
    r = float(np.float32(0.7))  # the table's radius; squared in double
    assert row[0] == np.float32(-5.0) and row[9] == np.float32(r * r)
    assert row[8] == np.float32(1.0)  # 1 / (t1 - t0)


def test_sphere_medium_scatters_at_its_free_path_rate():
    # The JAX bake cannot build a sphere medium's record (its dict names
    # the texture colour and the moving center both c1), so the plain
    # version is held to the physics instead: rays through the center of a
    # unit sphere of density 0.5 scatter inside with probability
    # 1 - exp(-0.5 * 2); a scattered ray meets nothing else by depth 1 and
    # carries 0, the others the white background.  4,096 rays: +-0.03 is
    # four standard deviations.
    b = SceneBuilder(background=(1.0, 1.0, 1.0))
    b.sphere_medium((0, 0, 0), 1.0, 0.5, (0.5, 0.5, 0.5))
    cam = Camera.make((0, 0, -10), (0, 0, 0), (0, 1, 0), 0.01, 1.0, 0.0,
                      10.0, 0.0, 1.0)
    out = ct.Tracer(b.build(), "cpu").trace_pixels(cam, 1, 1, 0, 4096, 9,
                                                   max_depth=1)
    scattered = float((out[:, 0] == 0.0).double().mean())
    assert abs(scattered - (1.0 - np.exp(-1.0))) < 0.03, scattered
    assert ((out == 0.0) | (out == 1.0)).all()


@pytest.mark.parametrize("fn", ["noise3", "turb3"])
def test_perlin_matches_jax(fn):
    rng = np.random.default_rng(61)
    p = (rng.standard_normal((3, 4096)) * np.array([[2.0], [40.0], [900.0]])
         ).astype(np.float32)
    want = np.asarray(getattr(pt, f"_{fn}")(*(jnp.asarray(x) for x in p)))
    got = getattr(perlin, fn)(*(torch.from_numpy(x) for x in p))
    np.testing.assert_array_equal(got.numpy(), want)  # exact
    assert np.abs(want).max() > 0.1


# ---------------------------------------------------------------------------
# the forward kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("name", SCENES)
def test_trace_pixels_matches_jax(pairs, name, depth):
    pair = pairs[name]
    seed = _seed(depth)
    want = pair.jtr.trace_pixels(pair.jsd.camera, H, W, 0, N,
                                 jnp.int32(seed), max_depth=depth, sub=8)
    got = ct.Tracer(pair.tsd.scene, "cpu").trace_pixels(
        pair.cam, H, W, 0, N, seed, max_depth=depth)
    assert got.dtype == torch.float32 and tuple(got.shape) == (N, 3)
    assert_matches(got.numpy(), np.asarray(want), depth)


def test_russian_roulette_matches_jax(pairs):
    pair = pairs["cornell_smoke"]
    seed = _seed(7)
    want = pair.jtr.trace_pixels(pair.jsd.camera, H, W, 0, N,
                                 jnp.int32(seed), max_depth=4, rr_start=1,
                                 sub=8)
    tracer = ct.Tracer(pair.tsd.scene, "cpu")
    got = tracer.trace_pixels(pair.cam, H, W, 0, N, seed, max_depth=4,
                              rr_start=1)
    assert_matches(got.numpy(), np.asarray(want), 4)
    plain = tracer.trace_pixels(pair.cam, H, W, 0, N, seed, max_depth=4)
    assert not torch.equal(got, plain)  # the roulette ran


# ---------------------------------------------------------------------------
# the record walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", RECORD_SCENES)
def test_record_plane_matches_jax(pairs, name):
    pair = pairs[name]
    assert not pair.jtr.need_p and not pair.jtr.need_uv
    seed = _seed(11)
    planes = pair.jtr.walk_packed_pixels(pair.jsd.camera, H, W, 0, N,
                                         jnp.int32(seed), max_depth=3)
    want = np.asarray(planes[0]).reshape(3, -1)[:, :N]
    got = ct.Tracer(pair.tsd.scene, "cpu").walk_packed_pixels(
        pair.cam, H, W, 0, N, seed, max_depth=3)[0]
    agree = ct.record_agreement(got, want)
    assert agree["first_bounce"] and agree["lane_frac"] >= 0.99, agree


@pytest.mark.parametrize("name", RECORD_SCENES)
def test_record_and_forward_trace_the_same_paths(pairs, name):
    pair = pairs[name]
    tracer = ct.Tracer(pair.tsd.scene, "cpu")
    seed = _seed(12)
    plane = tracer.walk_packed_pixels(pair.cam, H, W, 0, N, seed,
                                      max_depth=5)[0]
    fwd = tracer.trace_pixels(pair.cam, H, W, 0, N, seed, max_depth=5)
    rad = shade_packed(pair.tsd.scene, get_params(pair.tsd.scene, "cpu"),
                       plane, need_p=False, need_uv=False)
    np.testing.assert_array_equal(rad.numpy(), fwd.numpy())
    assert float(fwd.sum()) > 0.0


# ---------------------------------------------------------------------------
# the pinned goldens the card is held to
# ---------------------------------------------------------------------------


def _golden(name):
    g = np.load(os.path.join(DATA, f"{name}_32.npz"))
    st = RenderSettings(image_width=int(g["image_width"]),
                        aspect_ratio=float(g["aspect_ratio"]),
                        spp_per_chunk=int(g["spp_per_chunk"]), num_chunks=1,
                        max_depth=int(g["max_depth"]),
                        ray_batch=int(g["ray_batch"]), t_min=float(g["t_min"]))
    return g, st


@pytest.mark.parametrize("name", SCENES)
def test_chunk_matches_pinned_golden(name):
    g, st = _golden(name)
    tsd = tscenes.get(name)
    assert st.image_height == int(g["image_height"])
    got = compile_renderer(tsd.scene, tsd.camera, st, device="cpu")(
        int(g["base"]))
    assert tuple(got.shape) == g["sums"].shape
    assert_matches(got.numpy(), g["sums"], st.max_depth, mean_rtol=3e-3)


@pytest.mark.parametrize("name", RECORD_SCENES)
def test_record_walk_matches_pinned_golden(name):
    g, st = _golden(name)
    tsd = tscenes.get(name)
    b, h, w = int(g["record_ray_batch"]), st.image_height, st.image_width
    tracer = ct.Tracer(tsd.scene, "cpu")
    got = torch.stack([
        tracer.walk_packed_pixels(tsd.camera, h, w, bid * b, b,
                                  ct.wave_seed(int(g["base"]), s, bid),
                                  st.max_depth, st.t_min)[0]
        for s in range(st.spp_per_chunk) for bid in range(-(-h * w // b))])
    agree = ct.record_agreement(got, g["planes"])
    assert agree["first_bounce"] and agree["lane_frac"] >= 0.99, agree


# ---------------------------------------------------------------------------
# what is still refused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["two_spheres", "two_perlin_spheres"])
def test_record_mode_refuses_the_p_plane(name):
    # the record walk writes the hit-point planes these textures need, and
    # the uv planes of an image texture: training takes both
    tsd = tscenes.get(name)
    tracer = ct.Tracer(tsd.scene, "cpu")
    st = RenderSettings(image_width=16, aspect_ratio=tsd.aspect,
                        spp_per_chunk=1, num_chunks=1, max_depth=2)
    assert tracer.need_p and not tracer.need_uv
    planes = tracer.walk_packed_pixels(tsd.camera, 9, 16, 0, 16, 1, 2)
    assert [p.dtype for p in planes] == [torch.int32] + [torch.float32] * 3
    image = dataclasses.replace(tsd.scene, textures=dataclasses.replace(
        tsd.scene.textures,
        kind=np.full_like(tsd.scene.textures.kind, tst.TEX_IMAGE)))
    itracer = ct.Tracer(image, "cpu")
    assert itracer.need_uv and not itracer.need_p
    iplanes = itracer.walk_packed_pixels(tsd.camera, 9, 16, 0, 16, 1, 2)
    assert [p.dtype for p in iplanes] == [torch.int32] + [torch.float32] * 2
    assert torch.equal(iplanes[0], planes[0])  # the same paths
    chunk = fused_diff.compile_fused_param_renderer(
        image, tsd.camera, st.with_(image_width=4, ray_batch=16),
        device="cpu")
    assert bool(torch.isfinite(chunk(get_params(image, "cpu"), 1)).all())


def test_triangle_and_image_scenes_are_refused():
    # the triangle scene converts (its XLA BVH dropped) and renders, and
    # its record walk runs through the triangle BVH
    jsd = jscenes.get("triangle")
    tracer = ct.Tracer(scene_from_numpy(_tree(jsd.scene._host_np)), "cpu")
    planes = tracer.walk_packed_pixels(tscenes.get("triangle").camera, 9, 16,
                                       0, 16, 1, 2)
    assert len(planes) == 1 and planes[0].shape == (2, 16)
    # earth's image texture, on a synthetic image, carried across with its
    # atlas: the forward kernel refuses it by name, the record walk takes it
    b = JaxBuilder()
    b.sphere((0, 0, 0), 2, b.lambertian(b.image(np.ones((4, 8, 3)))))
    scene = scene_from_numpy(_tree(b.build()._host_np))
    assert ct.unported_feature(scene) is None
    assert ct.unported_record_feature(scene) is None
    np.testing.assert_array_equal(scene.atlas.data, np.ones(96, np.float32))
    tracer = ct.Tracer(scene, "cpu")
    with pytest.raises(ValueError, match="image texture"):
        tracer.trace_pixels(tscenes.get("basic").camera, 9, 16, 0, 16, 1, 2)
    assert len(tracer.walk_packed_pixels(tscenes.get("basic").camera, 9, 16,
                                         0, 16, 1, 2)) == 3


def test_cli_renders_with_russian_roulette(tmp_path):
    out = tmp_path / "s.png"
    assert cli.main(["render", "cornell_smoke", "--device", "cpu", "--width",
                     "12", "--spp", "1", "--chunks", "1", "--depth", "3",
                     "--rr-start", "1", "-o", str(out), "--quiet"]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
