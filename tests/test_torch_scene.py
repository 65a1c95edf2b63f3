"""The port's scene tables, camera and kernel bake against the JAX package.

Tables and bake records are compared exactly (the builders do the same
float32 arithmetic); the camera basis to rtol/atol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu_torch import SceneBuilder, compile_renderer
from raytracing_gpu_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from raytracing_gpu_tpu_torch.core.config import RenderSettings
from raytracing_gpu_tpu_torch.engine import diff, fused_diff
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct
from raytracing_gpu_tpu_torch.scene import types as tst

torch.set_num_threads(1)

TABLES = sorted(tst.TABLES)


def _tree(obj):
    """A JAX scene/camera pytree as nested dicts of numpy leaves."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, bool):
        return obj
    return np.asarray(obj)


@pytest.fixture(scope="module")
def cornell():
    return jscenes.get("cornell_box"), tscenes.get("cornell_box")


def _assert_tables_equal(jax_scene, port_scene, name):
    a, b = getattr(jax_scene, name), getattr(port_scene, name)
    for f in dataclasses.fields(b):
        x, y = np.asarray(getattr(a, f.name)), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, (name, f.name)
        np.testing.assert_array_equal(y, x, err_msg=f"{name}.{f.name}")


@pytest.mark.parametrize("name", TABLES)
def test_cornell_tables_equal_jax_host_snapshot(cornell, name):
    jsd, tsd = cornell
    _assert_tables_equal(jsd.scene._host_np, tsd.scene, name)  # exact


def test_cornell_scene_fields_equal(cornell):
    jsd, tsd = cornell
    host = jsd.scene._host_np
    np.testing.assert_array_equal(tsd.scene.background,
                                  np.asarray(host.background))
    assert tsd.scene.background.dtype == np.float32
    assert tsd.scene.tri_bvh is None and host.tri_bvh is None
    assert tsd.scene.sphere_bvh is None and host.sphere_bvh is None
    assert tsd.scene.has_sphere_media == host.has_sphere_media
    assert tsd.scene.has_box_media == host.has_box_media
    assert tsd.aspect == jsd.aspect


@pytest.mark.parametrize("name", TABLES)
def test_scene_from_numpy_equals_port_build(cornell, name):
    jsd, tsd = cornell
    converted = scene_from_numpy(_tree(jsd.scene._host_np))
    _assert_tables_equal(converted, tsd.scene, name)  # exact


def test_camera_basis_matches_jax(cornell):
    jsd, tsd = cornell
    for f in dataclasses.fields(tsd.camera):
        got = getattr(tsd.camera, f.name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(jsd.camera, f.name)),
                                   rtol=1e-6, atol=1e-6, err_msg=f.name)
    conv = camera_from_numpy(_tree(jsd.camera))
    for f in dataclasses.fields(conv):
        np.testing.assert_array_equal(getattr(conv, f.name).numpy(),
                                      np.asarray(getattr(jsd.camera, f.name)))


@pytest.mark.parametrize("vfov,aspect,aperture", [(20.0, 16 / 9, 0.1),
                                                  (90.0, 1.5, 0.0)])
def test_camera_make_matches_jax(vfov, aspect, aperture):
    from raytracing_gpu_tpu.core.camera import Camera as JCamera
    from raytracing_gpu_tpu_torch.core.camera import Camera as TCamera

    rng = np.random.default_rng(21)
    lookfrom, lookat = rng.normal(size=3) * 10, rng.normal(size=3)
    a = JCamera.make(lookfrom, lookat, (0, 1, 0), vfov, aspect, aperture, 7.5)
    b = TCamera.make(lookfrom, lookat, (0, 1, 0), vfov, aspect, aperture, 7.5)
    for f in dataclasses.fields(b):
        np.testing.assert_allclose(getattr(b, f.name).numpy(),
                                   np.asarray(getattr(a, f.name)),
                                   rtol=1e-6, atol=1e-6, err_msg=f.name)


def test_get_rays_matches_jax_without_a_lens(cornell):
    # aperture 0: origins and directions are deterministic, so the two
    # packages' generators do not matter; rtol/atol 1e-6
    import jax

    jsd, tsd = cornell
    rng = np.random.default_rng(22)
    s, t = rng.random(256, np.float32), rng.random(256, np.float32)
    jo, jd, _ = jsd.camera.get_rays(jax.random.PRNGKey(0), s, t)
    gen = torch.Generator().manual_seed(0)
    o, d, tm = tsd.camera.get_rays(gen, torch.from_numpy(s),
                                   torch.from_numpy(t))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    assert tm.shape == (256,) and bool(((tm >= 0) & (tm <= 1)).all())


def test_bake_records_equal_jax(cornell):
    jsd, tsd = cornell
    jb, tb = pt.bake_scene(jsd.scene), ct.bake_scene(tsd.scene)
    assert len(tb.rects) == len(jb.rects) == 6
    assert len(tb.boxes) == len(jb.boxes) == 2
    for mine, theirs in zip(tb.rects + tb.boxes, jb.rects + jb.boxes):
        assert mine == {k: theirs[k] for k in mine}  # exact
    assert tb.background == jb.background
    rt, bt = tb.rect_table(), tb.box_table()
    assert rt.shape == (6, ct.RECT_COLS) and bt.shape == (2, ct.BOX_COLS)
    assert rt[2, 6] == 3 and tuple(rt[2, 7:10]) == (15.0, 15.0, 15.0)


def test_big_scene1_is_refused_with_the_feature_named():
    # big_scene1 itself renders (the kernel bake builds its sphere BVH and
    # the XLA engine's BVH in the JAX tree is dropped), and so it does with
    # triangles added, in both modes; with an image texture the forward
    # kernel refuses it with that feature named, and it renders on the
    # record walk, whose planes carry the uv
    jsd = jscenes.get("big_scene1")
    assert jsd.scene._host_np.sphere_bvh is not None
    scene = scene_from_numpy(_tree(jsd.scene._host_np))
    assert ct.supports_forward(scene) and ct.Tracer(scene, "cpu").supports_hit
    assert ct.unported_record_feature(scene) is None
    cam = camera_from_numpy(_tree(jsd.camera))
    st = RenderSettings(image_width=16, aspect_ratio=jsd.aspect,
                        spp_per_chunk=1, num_chunks=1, max_depth=2)
    tri = dataclasses.replace(scene, triangles=dataclasses.replace(
        scene.triangles, active=np.ones_like(scene.triangles.active)))
    image = dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, kind=np.where(scene.textures.kind == tst.TEX_CHECKER,
                                      np.int32(tst.TEX_IMAGE),
                                      scene.textures.kind)))
    assert ct.unported_feature(tri) is None
    assert ct.unported_record_feature(tri) is None
    assert compile_renderer(tri, cam, st, device="cpu").engine_name == \
        "megakernel"
    planes = ct.Tracer(tri, "cpu").walk_packed_pixels(cam, 9, 16, 0, 16, 1)
    assert len(planes) == 4  # the checker ground needs the hit point
    assert ct.unported_feature(image) is None
    assert ct.unported_record_feature(image) is None
    assert not ct.supports_forward(image)
    tracer = ct.Tracer(image, "cpu")
    assert tracer.need_uv and not tracer.need_p
    with pytest.raises(ValueError, match="image texture"):
        tracer.trace_pixels(cam, 9, 16, 0, 16, 1)
    with pytest.raises(ValueError, match="image texture"):
        tracer.bind_trace_rays()
    chunk = compile_renderer(image, cam, st, device="cpu")
    assert chunk.engine_name == "record-walk"
    assert bool(torch.isfinite(chunk(3)).all())
    planes = tracer.walk_packed_pixels(cam, 9, 16, 0, 16, 1)
    assert len(planes) == 3  # packed, u, v: the ground's image needs uv


def test_unported_material_and_texture_are_named(cornell):
    _, tsd = cornell
    s = tsd.scene
    image = dataclasses.replace(s, textures=dataclasses.replace(
        s.textures, kind=np.full_like(s.textures.kind, tst.TEX_IMAGE)))
    # image textures are ported: only the forward kernel refuses them,
    # naming them, and the record walk writes their uv planes
    assert ct.unported_feature(image) is None
    assert ct.unported_record_feature(image) is None
    assert not ct.supports_forward(image) and ct.bake_scene(image).need_uv
    with pytest.raises(ValueError, match="image texture"):
        ct.Tracer(image, "cpu").bind(tsd.camera, 4, 4)
    media = SceneBuilder()
    for i in range(17):
        media.box_medium((i, 0, 0), (i + 1, 1, 1), 0.01, (1, 1, 1))
    assert ct.unported_feature(media.build()) == \
        "17 constant media (more than 16)"
    # both modes take a checker: the record walk writes its p plane
    checker = dataclasses.replace(s, textures=dataclasses.replace(
        s.textures, kind=np.ones_like(s.textures.kind)))
    assert ct.unported_feature(checker) is None
    assert ct.unported_record_feature(checker) is None
    assert ct.bake_scene(checker).need_p and not ct.bake_scene(s).need_p
    metal = dataclasses.replace(s.materials, kind=np.where(
        s.materials.kind == 0, np.int32(1), s.materials.kind))
    assert ct.unported_feature(dataclasses.replace(s, materials=metal)) is None
    assert ct.unported_feature(s) is None and ct.supports_forward(s)
    assert ct.unported_record_feature(s) is None


def _image_kind(scene):
    """`scene` with its first texture read as an image (with no image
    bound: cyan)."""
    kinds = scene.textures.kind.copy()
    kinds[0] = tst.TEX_IMAGE
    return dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, kind=kinds))


def _image_texture(b):
    # an image texture from an array: the atlas, and the record walk's uv
    # planes; 17 media are refused
    tex = b.image(np.full((2, 2, 4), 0.5, np.float32))
    b.rect("xy", 0, 1, 0, 1, 0, b.lambertian(tex))
    scene = b.build()
    assert scene.atlas.data.shape == (12,) and scene.atlas.width[0] == 2
    cam = tscenes.get("cornell_box").camera
    assert len(ct.Tracer(scene, "cpu").walk_packed_pixels(
        cam, 4, 4, 0, 16, 1)) == 3
    _many_media(b)


def _many_spheres(b):
    # the sphere BVH in both modes, and with an image texture in training;
    # 17 media are refused
    for i in range(65):
        b.sphere((i, 0, 0), 0.4, b.lambertian((0.5, 0.5, 0.5)))
    tsd = tscenes.get("cornell_box")
    scene = b.build()
    planes = ct.Tracer(scene, "cpu").walk_packed_pixels(tsd.camera, 4, 4, 0,
                                                        16, 1)
    assert planes[0].shape == (50, 16)
    st = RenderSettings(image_width=4, aspect_ratio=1.0, spp_per_chunk=1,
                        num_chunks=1, max_depth=2, ray_batch=16)
    chunk = fused_diff.compile_fused_param_renderer(
        _image_kind(scene), tsd.camera, st, device="cpu")
    assert tuple(chunk(diff.get_params(scene, "cpu"), 1).shape) == (16, 3)
    _many_media(b)


def _many_media(b):
    for i in range(17):
        b.box_medium((i, 0, 0), (i + 1, 1, 1), 0.01, (1, 1, 1))
    return ct.Tracer(b.build(), "cpu")


def _triangles_record_walk(b, add):
    # the triangle BVH in both modes, and the record walk of an
    # image-textured scene in training; 17 media are refused
    mat = b.lambertian((0.5, 0.5, 0.5))
    if add == "mesh":
        b.mesh(np.eye(3), np.array([[0, 1, 2]]), mat)
    elif add == "triangle":
        b.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), mat)
    else:  # a rotated rect lowers to two triangles
        b.rect("xy", 0, 1, 0, 1, 0, mat, rotate_y=30.0)
    cam = tscenes.get("cornell_box").camera
    scene = b.build()
    tracer = ct.Tracer(scene, "cpu")
    assert tracer.trace_pixels(cam, 4, 4, 0, 16, 1, 2).shape == (16, 3)
    assert len(tracer.walk_packed_pixels(cam, 4, 4, 0, 16, 1)) == 1
    st = RenderSettings(image_width=4, aspect_ratio=1.0, spp_per_chunk=1,
                        num_chunks=1, max_depth=2, ray_batch=16)
    image = _image_kind(scene)
    walk = ct.Tracer(image, "cpu").bind_record(cam, 4, 4, 2)
    chunk = fused_diff.fused_chunk_from_walk(image, walk, st, device="cpu")
    assert tuple(chunk(diff.get_params(image, "cpu"), 1).shape) == (16, 3)
    _many_media(b)


def _checker_record_walk(b):
    # the checker's p plane in record mode; 17 media are refused
    b.rect("xy", 0, 1, 0, 1, 0, b.lambertian(b.checker((0, 0, 0), (1, 1, 1))))
    cam = tscenes.get("cornell_box").camera
    assert len(ct.Tracer(b.build(), "cpu").walk_packed_pixels(
        cam, 4, 4, 0, 16, 1)) == 4
    _many_media(b)


@pytest.mark.parametrize("call", [
    _image_texture,
    lambda b: _triangles_record_walk(b, "mesh"),
    _many_spheres,
    _many_media,
    lambda b: _triangles_record_walk(b, "triangle"),
    _checker_record_walk,
    lambda b: _triangles_record_walk(b, "rotated rect"),
])
def test_builder_refuses_unported_features(call):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        call(SceneBuilder())


def test_registry_lists_only_ported_scenes():
    assert tscenes.names() == sorted(jscenes.names()) == [
        "backpack", "basic", "big_scene1", "cornell_box", "cornell_smoke",
        "cup", "door", "earth", "first", "triangle", "triangles",
        "two_perlin_spheres", "two_spheres"]
    with pytest.raises(KeyError, match="not ported"):
        tscenes.get("moon")
