"""Image textures in the port against the JAX package, on the CPU.

- `io.images.load_image` and `io.obj.load_obj` equal the JAX package's on
  files the tests write (exactly);
- the builder's atlas tables, and every other table, equal the JAX
  builder's host snapshot (`_host_np`) for a two-image scene, and for
  `earth`, `door` and `backpack` with assets in a temporary directory and
  without (exactly);
- `textures._eval_image` equals the JAX lookup on uv inside, outside and on
  the edges of [0, 1] and on an unbound image (rtol 1e-6: both gather the
  same float32 texels);
- `materials.shade`'s `atlas_data` gradient equals JAX's VJP in both images
  of the two-image scene (rtol 1e-5, atol 1e-7: scatter-adds in another
  order), and each primitive's texels come from its own image;
- scenes whose textures are all solid or checker (Cornell, big_scene1,
  `triangles`) never reach `eval_texture`'s gathers, whose backward is an
  atomic scatter-add: their training gradients stay as before;
- the engine names of `compile_renderer` equal the JAX package's for image
  scenes at depth 8 and 50, with russian roulette off and on, and for the
  backpack stand-in with its diffuse map.

The images are synthetic (`models.probes.synthetic_image`): the reference
assets are not part of the repository.
"""

import contextlib
import dataclasses
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from raytracing_gpu_tpu.core.camera import Camera as JCamera
from raytracing_gpu_tpu.core.config import RenderSettings as JSettings
from raytracing_gpu_tpu.engine.render import compile_renderer as jcompile
from raytracing_gpu_tpu.io import images as jimages
from raytracing_gpu_tpu.io import obj as jobj
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu.scene import materials as jmaterials
from raytracing_gpu_tpu.scene import textures as jtextures
from raytracing_gpu_tpu.scene.builder import SceneBuilder as JBuilder
from raytracing_gpu_tpu_torch import (Camera, RenderSettings, SceneBuilder,
                                      cli, compile_renderer)
from raytracing_gpu_tpu_torch.engine import diff
from raytracing_gpu_tpu_torch.io import images, obj
from raytracing_gpu_tpu_torch.models import probes
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct
from raytracing_gpu_tpu_torch.scene import materials, textures
from raytracing_gpu_tpu_torch.scene import types as tst

torch.set_num_threads(1)

TABLES = sorted(tst.TABLES)


def _png(path, img):
    """Write a float image in [0, 1] as an 8-bit PNG (exact for k/255)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray((img * 255.0).round().astype(np.uint8)).save(
        str(path), format="PNG")


def _assert_scene_equal(jscene, tscene):
    host = jscene._host_np
    for name in TABLES:
        a, b = getattr(host, name), getattr(tscene, name)
        for f in dataclasses.fields(b):
            x, y = np.asarray(getattr(a, f.name)), getattr(b, f.name)
            assert x.dtype == y.dtype and x.shape == y.shape, (name, f.name)
            np.testing.assert_array_equal(y, x, err_msg=f"{name}.{f.name}")
    np.testing.assert_array_equal(tscene.background,
                                  np.asarray(host.background))


@contextlib.contextmanager
def _assets(root):
    """Both packages reading their reference assets from `root` (the JAX
    package reads REFERENCE_ROOT at import, the port the environment)."""
    old_env = os.environ.get("RT_REFERENCE_ASSETS")
    old_root = jscenes.REFERENCE_ROOT
    os.environ["RT_REFERENCE_ASSETS"] = jscenes.REFERENCE_ROOT = str(root)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # JAX's stand-in warning
            yield
    finally:
        jscenes.REFERENCE_ROOT = old_root
        if old_env is None:
            del os.environ["RT_REFERENCE_ASSETS"]
        else:
            os.environ["RT_REFERENCE_ASSETS"] = old_env


@pytest.fixture(scope="module")
def probe():
    imgs = (probes.synthetic_image(48, 64, 1), probes.synthetic_image(40, 40, 2))
    jscene, _, _ = probes.image_probe(JBuilder, JCamera, imgs)
    tscene, tcam, _ = probes.image_probe(SceneBuilder, Camera, imgs)
    return jscene, tscene, tcam


def test_load_image_matches_jax(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (5, 7, 4), np.uint8)
    path = tmp_path / "rgba.png"
    Image.fromarray(img, "RGBA").save(str(path))
    got, want = images.load_image(str(path)), jimages.load_image(str(path))
    assert got.dtype == np.float32 and got.shape == (5, 7, 3)
    np.testing.assert_array_equal(got, want)


OBJ = """mtllib two.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0.5
vn 0 0 1
vn 0 1 0
usemtl wood
f 1/1/1 2/2/1 3/3/1 4/4/1
f -1/-3/-1 -4/-2/-1 -5/-4/-1
usemtl metal
f 1//2 2//2 5//2
f 2 3 5
usemtl bare
f 1 3 5
"""

MTL = """newmtl wood
Kd 0.8 0.6 0.4
map_Kd -bm 0.5 wood.png
newmtl metal
map_Kd metal.png
newmtl bare
Kd 0.1 0.2 0.3
"""


def test_load_obj_matches_jax(tmp_path):
    # quads, negative indices, faces without normals or uvs, two submeshes
    # with a map_Kd each and one with a color only
    (tmp_path / "two.obj").write_text(OBJ)
    (tmp_path / "two.mtl").write_text(MTL)
    _png(tmp_path / "wood.png", probes.synthetic_image(4, 4, 1))
    _png(tmp_path / "metal.png", probes.synthetic_image(4, 4, 2))
    got = obj.load_obj(str(tmp_path / "two.obj"))
    want = jobj.load_obj(str(tmp_path / "two.obj"))
    assert got.num_triangles == want.num_triangles == 6
    assert len(got.submeshes) == len(want.submeshes) == 3
    for a, b in zip(got.submeshes, want.submeshes):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name
    assert [s.diffuse_texture is not None for s in got.submeshes] == [
        True, True, False]
    assert got.submeshes[0].diffuse_color == (0.8, 0.6, 0.4)


def test_builder_atlas_equals_jax(probe):
    jscene, tscene, _ = probe
    _assert_scene_equal(jscene, tscene)
    at = tscene.atlas
    assert list(at.offset) == [0, 48 * 64] and list(at.width) == [64, 40]
    # no image: the one-texel empty atlas
    b = SceneBuilder()
    b.sphere((0, 0, 0), 1, b.lambertian((1, 0, 0)))
    jb = JBuilder()
    jb.sphere((0, 0, 0), 1, jb.lambertian((1, 0, 0)))
    _assert_scene_equal(jb.build(), b.build())


@pytest.mark.parametrize("img", [np.zeros((4, 4)), np.zeros((4, 4, 2)),
                                 np.zeros((2, 2, 2, 3))])
def test_builder_refuses_a_bad_image_shape(img):
    with pytest.raises(ValueError, match="H, W, >=3"):
        SceneBuilder().image(img)
    with pytest.raises(ValueError, match="H, W, >=3"):
        JBuilder().image(img)


DOOR_OBJ = """mtllib door.mtl
v -1 0 0
v 1 0 0
v 1 2 0
v -1 2 0
v 0 1 0.1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl panel
f 1/1 2/2 3/3 4/4
usemtl knob
f 2/2 5/3 3/3
"""


@pytest.mark.parametrize("name", ["earth", "earth-fallback", "door",
                                  "backpack"])
def test_asset_scenes_match_jax(name, tmp_path):
    if name == "earth":
        _png(tmp_path / "textures" / "earthmap.jpg",
             probes.synthetic_image(16, 32, 7))
    elif name == "door":
        d = tmp_path / "assets" / "door"
        d.mkdir(parents=True)
        (d / "door.obj").write_text(DOOR_OBJ)
        (d / "door.mtl").write_text("newmtl panel\nmap_Kd Door_C.jpg\n"
                                    "newmtl knob\nKd 0.9 0.8 0.1\n")
        _png(d / "Door_C.jpg", probes.synthetic_image(8, 6, 8))
    elif name == "backpack":
        # the diffuse map without the OBJ: the stand-in, its map subsampled
        # to at most 1024 texels a side (every 2nd here)
        _png(tmp_path / "assets" / "backpack" / "diffuse.jpg",
             probes.synthetic_image(1100, 40, 9))
    scene = name.split("-")[0]
    with _assets(tmp_path):
        jsd, tsd = jscenes.get(scene), tscenes.get(scene)
    _assert_scene_equal(jsd.scene, tsd.scene)
    kinds = set(tsd.scene.textures.kind.tolist())
    assert (tst.TEX_IMAGE in kinds) == (name != "earth-fallback")
    if name == "backpack":
        assert tuple(tsd.scene.atlas.height) == (550,)


def test_eval_image_matches_jax(probe):
    jscene, tscene, _ = probe
    params = diff.get_params(tscene, "cpu")
    edges = np.array([-0.5, -1e-7, 0.0, 1e-7, 0.5, 1 - 1e-7, 1.0, 1.5],
                     np.float32)
    rng = np.random.default_rng(17)
    u = np.concatenate([np.repeat(edges, len(edges)),
                        rng.uniform(-0.2, 1.2, 512)]).astype(np.float32)
    v = np.concatenate([np.tile(edges, len(edges)),
                        rng.uniform(-0.2, 1.2, 512)]).astype(np.float32)
    image_id = rng.integers(-1, 2, len(u)).astype(np.int32)
    got = textures._eval_image(tscene, params["atlas_data"],
                               torch.from_numpy(image_id),
                               torch.from_numpy(u), torch.from_numpy(v))
    want = jtextures._eval_image(jscene, jnp.asarray(image_id),
                                 jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert (got.numpy()[image_id < 0] == (0.0, 1.0, 1.0)).all()


def _shade_inputs(scene, n=2048, seed=29):
    rng = np.random.default_rng(seed)
    mat_id = rng.integers(0, len(scene.materials.kind), n).astype(np.int32)
    u, v = rng.uniform(-0.1, 1.1, (2, n)).astype(np.float32)
    p = rng.uniform(0.0, 555.0, (n, 3)).astype(np.float32)
    g_att, g_emit = rng.standard_normal((2, n, 3)).astype(np.float32)
    return mat_id, u, v, p, g_att, g_emit


def test_shade_atlas_gradient_matches_jax_in_both_images(probe):
    jscene, tscene, _ = probe
    mat_id, u, v, p, g_att, g_emit = _shade_inputs(tscene)
    params = {k: t.requires_grad_(True)
              for k, t in diff.get_params(tscene, "cpu").items()}
    att, emit = materials.shade(tscene, params, torch.from_numpy(mat_id),
                                torch.from_numpy(u), torch.from_numpy(v),
                                torch.from_numpy(p))
    got = torch.autograd.grad((att, emit), params["atlas_data"],
                              (torch.from_numpy(g_att),
                               torch.from_numpy(g_emit)))[0].numpy()

    def shade(data):
        scene = jscene.replace(atlas=jscene.atlas.replace(data=data))
        return jmaterials.shade(scene, jnp.asarray(mat_id), jnp.asarray(u),
                                jnp.asarray(v), jnp.asarray(p))

    import jax

    (jatt, jemit), vjp = jax.vjp(shade, jscene.atlas.data)
    want = np.asarray(vjp((jnp.asarray(g_att), jnp.asarray(g_emit)))[0])
    np.testing.assert_allclose(att.detach().numpy(), np.asarray(jatt),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    split = int(tscene.atlas.offset[1]) * 3
    assert (got[:split] != 0).sum() > 100 and (got[split:] != 0).sum() > 100


def test_each_primitive_reads_its_own_image(probe):
    # the probe's record walk, shaded per material: the atlas gradient of a
    # material's hits lies inside the span of the image its texture binds
    _, tscene, tcam = probe
    tracer = ct.Tracer(tscene, "cpu")
    planes = tracer.walk_packed_pixels(tcam, 32, 32, 0, 1024, 7, 2)
    hit = ((planes[0] >> 16) & 1) == 1
    mat, u, v = (planes[0] & 0xFFFF)[hit], planes[1][hit], planes[2][hit]
    at = tscene.atlas
    spans = [(3 * int(o), 3 * int(o + w * h))
             for o, w, h in zip(at.offset, at.width, at.height)]
    image_of = tscene.textures.image_id[tscene.materials.tex_id]
    seen = set()
    for m in np.unique(mat.numpy()):
        if image_of[m] < 0:
            continue
        params = {k: t.requires_grad_(k == "atlas_data")
                  for k, t in diff.get_params(tscene, "cpu").items()}
        sel = mat == int(m)
        att, _ = materials.shade(tscene, params, mat[sel], u[sel], v[sel],
                                 torch.zeros(int(sel.sum()), 3))
        g = torch.autograd.grad(att.sum(), params["atlas_data"])[0]
        lo, hi = spans[image_of[m]]
        nz = torch.nonzero(g)[:, 0]
        assert len(nz) and int(nz.min()) >= lo and int(nz.max()) < hi, m
        seen.add(int(image_of[m]))
    assert seen == {0, 1}


def _routes(jscene, tscene, jcam, tcam, aspect, jtracer):
    """The engine names of both packages over depth 8 and 50, russian
    roulette off and on, at 2 and 16 spp per chunk, with the JAX tracer
    baked once."""
    names = []
    real = pt.PallasTracer
    pt.PallasTracer = lambda scene: jtracer
    try:
        for depth in (8, 50):
            for rr in (0, 2):
                for spp in (2, 16):
                    kw = dict(image_width=16, aspect_ratio=aspect,
                              spp_per_chunk=spp, num_chunks=1,
                              max_depth=depth, ray_batch=256, rr_start=rr)
                    want = jcompile(jscene, jcam, JSettings(**kw),
                                    engine="pallas").engine_name
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        got = compile_renderer(tscene, tcam,
                                               RenderSettings(**kw),
                                               device="cpu").engine_name
                    assert got == want, (depth, rr, spp)
                    names.append(got)
    finally:
        pt.PallasTracer = real
    return names


@pytest.mark.parametrize("name", ["cornell_box", "big_scene1", "triangles"])
def test_solid_scenes_do_not_reach_the_texture_gathers(name, monkeypatch):
    sd = tscenes.get(name)
    m = len(sd.scene.materials.kind)

    def reached(*args, **kwargs):
        raise AssertionError("eval_texture reached")

    monkeypatch.setattr(materials, "eval_texture", reached)
    mat_id = torch.arange(m).repeat(4)
    n = len(mat_id)
    att, emit = materials.shade(sd.scene, diff.get_params(sd.scene, "cpu"),
                                mat_id, torch.zeros(n), torch.zeros(n),
                                torch.ones(n, 3))
    assert att.shape == emit.shape == (n, 3)
    assert bool(torch.isfinite(att).all() and torch.isfinite(emit).all())


@pytest.mark.parametrize("name", ["earth", "image_probe", "backpack"])
def test_routing_matches_jax(name, probe, tmp_path):
    if name == "image_probe":
        jscene, tscene, tcam = probe
        _, jcam, aspect = probes.image_probe(JBuilder, JCamera)
    else:
        path = {"earth": ("textures", "earthmap.jpg"),
                "backpack": ("assets", "backpack", "diffuse.jpg")}[name]
        _png(tmp_path.joinpath(*path), probes.synthetic_image(16, 32, 7))
        with _assets(tmp_path):
            jsd, tsd = jscenes.get(name), tscenes.get(name)
        jscene, tscene, jcam, tcam, aspect = (jsd.scene, tsd.scene,
                                              jsd.camera, tsd.camera,
                                              jsd.aspect)
    names = _routes(jscene, tscene, jcam, tcam, aspect,
                    pt.PallasTracer(jscene))
    want = {"earth": ["record-walk", "record-walk", "wavefront", "regen",
                      "wavefront", "regen", "wavefront", "regen"],
            # media: no hit kernel, so the record walk throughout
            "image_probe": ["record-walk"] * 8,
            "backpack": ["wavefront", "regen"] * 4}[name]
    assert names == want


def test_record_walk_route_ignores_russian_roulette(probe):
    _, tscene, tcam = probe
    st = RenderSettings(image_width=8, aspect_ratio=1.0, spp_per_chunk=1,
                        num_chunks=1, max_depth=3, ray_batch=64, rr_start=2)
    with pytest.warns(UserWarning, match="rr_start ignored"):
        chunk = compile_renderer(tscene, tcam, st, device="cpu")
    assert chunk.engine_name == "record-walk"
    assert bool(torch.isfinite(chunk(3)).all())


def test_cli_lists_and_renders_earth(tmp_path, capsys):
    assert cli.main(["list"]) == 0
    listed = capsys.readouterr().out.split()
    assert "earth" in listed and len(listed) == 13
    out = tmp_path / "e.png"
    assert cli.main(["render", "earth", "--device", "cpu", "--width", "12",
                     "--spp", "1", "--chunks", "1", "--depth", "3", "-o",
                     str(out), "--quiet"]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
