"""Triangles in the port against the JAX package, on the CPU: the builder's
tables, the kernel bakes, the wavefront's attribute table, the routing of
`compile_renderer`, and what is still refused.

- `triangle`, `triangles`, `door`, `backpack` and `cup` (the last three as
  the 100,352-triangle UV-sphere stand-in: the OBJ assets are absent), a
  rotated rect, and meshes with uvs, normals, rotate_y, translate and scale
  build tables equal to the JAX builder's host snapshot, bit for bit.
- The megakernel's 40-column rows, the hit tier's packed geometry, its
  slot -> triangle map and nodes, `pack_attr_table`, `supports_hit`, the
  JAX routing predicate (`jax_tri_stream`) and the world bounds equal the
  JAX bake's and tracer's.  On `triangles` the JAX bake's table is
  resident, so the whole leaf-contiguous table and its BVH are equal; on
  `backpack` the JAX bake streams a table of leaves of 32, so its rows are
  compared as a set (per triangle, each row once).
- The engine tags equal JAX `compile_renderer(engine="pallas")` for
  `triangles`, `backpack` and UV-sphere meshes on both sides of the JAX
  bake's resident edge (8,192 and 10,952 triangles).
- The record walk and both training entries refuse triangles, and a mesh
  scene whose reference assets exist refuses them by name.

One JAX bake of the 100k mesh, module-scoped.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.core.config import RenderSettings as JSettings
from raytracing_gpu_tpu.engine import wavefront as jwf
from raytracing_gpu_tpu.engine.render import compile_renderer as jcompile
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu.scene.builder import SceneBuilder as JaxBuilder
from raytracing_gpu_tpu_torch import RenderSettings, SceneBuilder
from raytracing_gpu_tpu_torch.engine import diff, fused_diff
from raytracing_gpu_tpu_torch.engine import wavefront as twf
from raytracing_gpu_tpu_torch.engine.render import compile_renderer
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct
from raytracing_gpu_tpu_torch.scene import types as tst

torch.set_num_threads(1)

TABLES = sorted(tst.TABLES)
MESH_SCENES = ("triangle", "triangles", "door", "backpack", "cup")
EDGE_RES = ((64, 64), (74, 74))  # 8,192 and 10,952 triangles


def uv_sphere_scene(builder, scenes_mod, res):
    """A UV-sphere mesh at the backpack stand-in's framing on the backpack's
    ground sphere, with either package's builder and registry."""
    b = builder(background=(0.7, 0.8, 1.0))
    tex = b.solid((0.8, 0.2, 0.2))
    v, f, uvs, n = scenes_mod._uv_sphere(*res)
    v = v * 0.45
    v[:, 1] += 0.45
    b.mesh(v, f, b.lambertian(tex), uvs=uvs, normals=n)
    b.sphere((0, -100, -1), 100, b.lambertian((0, 1, 0)))
    return b.build()


def assert_tables_equal(jscene, tscene):
    host = getattr(jscene, "_host_np", jscene)
    for table in TABLES:
        a, b = getattr(host, table), getattr(tscene, table)
        for f in dataclasses.fields(b):
            x, y = np.asarray(getattr(a, f.name)), getattr(b, f.name)
            assert x.dtype == y.dtype and x.shape == y.shape, (table, f.name)
            np.testing.assert_array_equal(y, x, err_msg=f"{table}.{f.name}")
    np.testing.assert_array_equal(tscene.background,
                                  np.asarray(host.background))


@pytest.fixture(scope="module")
def backpack():
    jsd, tsd = jscenes.get("backpack"), tscenes.get("backpack")
    return jsd, tsd, pt.PallasTracer(jsd.scene), ct.Tracer(tsd.scene, "cpu")


@pytest.fixture(scope="module")
def triangles():
    jsd, tsd = jscenes.get("triangles"), tscenes.get("triangles")
    return jsd, tsd, pt.PallasTracer(jsd.scene), ct.Tracer(tsd.scene, "cpu")


@pytest.mark.parametrize("name", MESH_SCENES)
def test_mesh_scene_tables_equal_jax(name, backpack):
    jsd, tsd = ((backpack[0], backpack[1]) if name == "backpack"
                else (jscenes.get(name), tscenes.get(name)))
    assert_tables_equal(jsd.scene, tsd.scene)
    assert tsd.aspect == jsd.aspect
    for f in ("origin", "lower_left_corner", "horizontal", "vertical"):
        np.testing.assert_array_equal(getattr(tsd.camera, f).numpy(),
                                      np.asarray(getattr(jsd.camera, f)))
    n = int(tsd.scene.triangles.active.sum())
    assert n == {"triangle": 1, "triangles": 4}.get(name, 100352)


def _builders(call):
    jb, tb = JaxBuilder(), SceneBuilder()
    call(jb)
    call(tb)
    return jb.build(), tb.build()


@pytest.mark.parametrize("case", ["rotated_rect", "mesh_normals",
                                  "mesh_flat", "triangle_normals"])
def test_builder_triangles_equal_jax(case):
    rng = np.random.default_rng(4)
    verts = rng.uniform(-2, 2, (30, 3)).astype(np.float32)
    faces = rng.integers(0, 30, (40, 3))
    uvs = rng.random((30, 2)).astype(np.float32)
    normals = rng.normal(size=(30, 3)).astype(np.float32)

    def call(b):
        mat = b.lambertian((0.3, 0.6, 0.9))
        if case == "rotated_rect":
            b.rect("xy", 0, 1, 0, 2, 0.5, mat, rotate_y=30.0,
                   translate=(1, 2, 3))
            b.rect("yz", -1, 1, 0, 2, 3, mat, rotate_y=-75.0)
            b.rect("xz", 0, 5, 0, 5, 1, mat, translate=(1, 0, 0))
        elif case == "mesh_normals":
            b.mesh(verts, faces, mat, uvs=uvs, normals=normals,
                   rotate_y=37.0, translate=(0.5, -1, 2), scale=1.7)
        elif case == "mesh_flat":
            b.mesh(verts, faces, mat, rotate_y=-120.0, scale=0.3)
        else:
            b.triangle((0, 0, 0), (1, 0, 0.5), (0, 1, 0), mat,
                       uv0=(0, 0), uv1=(1, 0), uv2=(0, 1),
                       normals=((0, 0, 1), (0, 1, 1), (1, 0, 1)))
            b.triangle((0, 0, 1), (2, 0, 1), (0, 3, 1), mat)
            b.mesh(verts[:5], faces[:3] % 5, mat)

    jscene, tscene = _builders(call)
    assert_tables_equal(jscene, tscene)
    assert tscene.triangles.active.sum() > 0


def test_triangles_bake_equals_jax(triangles):
    """The resident JAX bake: the whole table, its BVH, the hit tier."""
    jb, tb = triangles[2].bake, triangles[3].bake
    assert jb.tri_mode == "resident" and jb.tri_leaf_k == ct.TRI_LEAF_K
    np.testing.assert_array_equal(tb.tri_table, jb.tri_table)
    np.testing.assert_array_equal(tb.tri_nodes, jb.tri_nodes)
    np.testing.assert_array_equal(tb.tri_links, jb.tri_links)
    np.testing.assert_array_equal(tb.tri_start, jb.tri_start)
    assert sorted(tb.tri_ids[tb.tri_ids >= 0]) == [0, 1, 2, 3]
    assert_hit_tier_equal(jb, tb)


def assert_hit_tier_equal(jb, tb):
    """The packed geometry per slot, the slot -> id map and the nodes; the
    port's node column 6 holds a leaf's first slot, the JAX bake's its
    first 14-triangle row."""
    assert jb.hit_rows_per_leaf * pt._HIT_PACK == ct.HIT_TRI_LEAF_K
    geom = jb.tri_geom[:, :pt._HIT_PACK * 9].reshape(-1, 9)
    np.testing.assert_array_equal(tb.tri_geom, geom)
    np.testing.assert_array_equal(tb.tri_perm, jb.tri_perm)
    # past column 23 the JAX bake keeps per-row boxes its kernel never
    # reads (`has_rowbb = False`), which the port does not bake
    hn = jb.hit_nodes[:, :pt._HIT_NODE_COLS]
    keep = [c for c in range(ct.HIT_NODE_COLS) if c != 6]
    np.testing.assert_array_equal(tb.tri_hit_nodes[:, keep], hn[:, keep])
    leaf = hn[:, 6] >= 0
    np.testing.assert_array_equal(tb.tri_hit_nodes[leaf, 6],
                                  hn[leaf, 6] * pt._HIT_PACK)
    np.testing.assert_array_equal(tb.tri_hit_nodes[~leaf, 6], hn[~leaf, 6])


def test_backpack_bake_equals_jax(backpack):
    jtr, ttr = backpack[2], backpack[3]
    jb, tb = jtr.bake, ttr.bake
    assert jb.tri_mode == "stream" and tb.jax_tri_stream
    # every triangle's row once, as the JAX bake's leaf-32 table has it
    mine = tb.tri_table[tb.tri_ids >= 0]
    theirs = jb.tri_table[np.abs(jb.tri_table).sum(1) > 0]
    assert mine.shape == theirs.shape == (100352, ct.TRI_COLS)
    np.testing.assert_array_equal(mine[np.lexsort(mine.T[::-1])],
                                  theirs[np.lexsort(theirs.T[::-1])])
    # row k of the leaf-contiguous table is triangle tri_ids[k]'s row
    tr = backpack[1].scene.triangles
    ids = tb.tri_ids[tb.tri_ids >= 0]
    np.testing.assert_array_equal(mine[:, 0:3], tr.v0[ids])
    np.testing.assert_array_equal(mine[:, ct.TRI_N0:ct.TRI_N0 + 3],
                                  tr.n0[ids])
    assert not tb.tri_table[tb.tri_ids < 0].any()  # pad rows are all zero
    assert len(tb.tri_table) % ct.TRI_LEAF_K == 0
    assert_hit_tier_equal(jb, tb)
    assert tb.tri_geom.shape == (144172, 9) and len(tb.tri_hit_nodes) == 10297
    # 448 degenerate pole triangles (444 with an edge of length 0): their
    # determinant stays below the 1e-7 cut
    e1, e2 = tr.e1[tr.active], tr.e2[tr.active]
    assert int((np.linalg.norm(np.cross(e1, e2), axis=1) < 1e-9).sum()) == 448


@pytest.mark.parametrize("which", ["triangles", "backpack"])
def test_tracer_fields_and_attr_table_equal_jax(which, triangles, backpack):
    jsd, tsd, jtr, ttr = triangles if which == "triangles" else backpack
    assert ttr.supports_hit and jtr.supports_hit
    assert ttr.bake.jax_tri_stream == jtr.bake.tri_stream
    for mine, theirs in ((ttr.world_lo, jtr.world_lo),
                         (ttr.world_hi, jtr.world_hi)):
        assert mine.dtype == np.float32
        np.testing.assert_array_equal(mine, np.asarray(theirs))
    want = np.asarray(jwf.pack_attr_table(jsd.scene, jtr.bake.tri_perm))
    got = twf.pack_attr_table(tsd.scene, ttr.bake.tri_perm)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    feat = ttr.bake.features()
    assert feat & ct.FEAT_TRI_BVH and feat & ct.FEAT_SPHERES
    assert not feat & (ct.FEAT_CHECKER | ct.FEAT_MEDIA)


@pytest.mark.parametrize("res", EDGE_RES)
def test_resident_edge_equals_jax(res):
    jscene = uv_sphere_scene(JaxBuilder, jscenes, res)
    tscene = uv_sphere_scene(SceneBuilder, tscenes, res)
    assert_tables_equal(jscene, tscene)
    jtr, ttr = pt.PallasTracer(jscene), ct.Tracer(tscene, "cpu")
    assert ttr.bake.jax_tri_stream == jtr.bake.tri_stream
    assert ttr.bake.jax_tri_stream == (res == EDGE_RES[1])
    np.testing.assert_array_equal(ttr.world_lo, np.asarray(jtr.world_lo))
    np.testing.assert_array_equal(ttr.world_hi, np.asarray(jtr.world_hi))
    if not jtr.bake.tri_stream:  # the same resident table and BVH
        np.testing.assert_array_equal(ttr.bake.tri_table, jtr.bake.tri_table)
        np.testing.assert_array_equal(ttr.bake.tri_links,
                                      jtr.bake.tri_links)
    _routes_equal(jscene, tscene, jscenes.get("triangles").camera,
                  tscenes.get("triangles").camera, 16 / 9, tracer=jtr)


def _routes_equal(jscene, tscene, jcam, tcam, aspect, tracer):
    """The engine tags of both packages at spp 16, spp 4 and spp 16 + rr
    (depth 4: no sphere-BVH clause), with the JAX tracer baked once."""
    tags = []
    real = pt.PallasTracer
    pt.PallasTracer = lambda scene: tracer
    try:
        for spp, rr in ((16, 0), (4, 0), (16, 2)):
            kw = dict(image_width=32, aspect_ratio=aspect, spp_per_chunk=spp,
                      num_chunks=1, max_depth=4, ray_batch=512, rr_start=rr)
            want = jcompile(jscene, jcam, JSettings(**kw),
                            engine="pallas").engine_name
            got = compile_renderer(tscene, tcam, RenderSettings(**kw),
                                   device="cpu").engine_name
            assert got == want, (spp, rr)
            tags.append(got)
    finally:
        pt.PallasTracer = real
    return tags


@pytest.mark.parametrize("which", ["triangles", "backpack"])
def test_routing_tags_equal_jax(which, triangles, backpack):
    jsd, tsd, jtr, _ = triangles if which == "triangles" else backpack
    tags = _routes_equal(jsd.scene, tsd.scene, jsd.camera, tsd.camera,
                         jsd.aspect, jtr)
    assert tags == (["megakernel"] * 3 if which == "triangles"
                    else ["regen", "wavefront", "regen"])


def test_record_walk_and_training_refuse_triangles(triangles):
    # the record walk and training take triangles now, and an image texture
    # on them too (the uv planes)
    tsd, ttr = triangles[1], triangles[3]
    st = RenderSettings(image_width=16, aspect_ratio=tsd.aspect,
                        spp_per_chunk=1, num_chunks=1, max_depth=2,
                        ray_batch=144)
    assert ct.unported_feature(tsd.scene) is None
    assert ct.unported_record_feature(tsd.scene) is None
    assert len(ttr.walk_packed_pixels(tsd.camera, 9, 16, 0, 16, 1, 2)) == 1
    chunk = fused_diff.compile_fused_param_renderer(tsd.scene, tsd.camera, st,
                                                    device="cpu")
    assert tuple(chunk(diff.get_params(tsd.scene, "cpu"), 3).shape) == \
        (144, 3)
    image = dataclasses.replace(tsd.scene, textures=dataclasses.replace(
        tsd.scene.textures,
        kind=np.full_like(tsd.scene.textures.kind, tst.TEX_IMAGE)))
    assert ct.unported_record_feature(image) is None
    ichunk = fused_diff.compile_fused_param_renderer(image, tsd.camera, st,
                                                     device="cpu")
    assert bool(torch.isfinite(ichunk(diff.get_params(image, "cpu"),
                                      3)).all())
    planes = ct.Tracer(image, "cpu").walk_packed_pixels(tsd.camera, 9, 16, 0,
                                                        16, 1, 2)
    assert len(planes) == 3  # packed, u, v


def test_mesh_scene_with_reference_assets_is_refused(monkeypatch, tmp_path):
    # the OBJ asset loads (io.obj), with its Kd color where it has no map
    obj = tmp_path / "assets" / "cup" / "cup.obj"
    obj.parent.mkdir(parents=True)
    obj.write_text("mtllib cup.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                   "usemtl tin\nf 1 2 3\n")
    (obj.parent / "cup.mtl").write_text("newmtl tin\nKd 0.5 0.25 0.125\n")
    monkeypatch.setenv("RT_REFERENCE_ASSETS", str(tmp_path))
    cup = tscenes.get("cup").scene
    assert cup.triangles.active.sum() == 1
    np.testing.assert_array_equal(cup.textures.c1[0],
                                  np.float32([0.5, 0.25, 0.125]))
    assert tscenes.get("door").scene.triangles.active.sum() == 100352
    monkeypatch.setenv("RT_REFERENCE_ASSETS",
                       str(tmp_path / "nothing-here"))
    assert tscenes.get("cup").scene.triangles.active.sum() == 100352


def test_attr_table_needs_the_slot_map(triangles):
    with pytest.raises(ValueError, match="tri_perm"):
        twf.pack_attr_table(triangles[1].scene)
    empty = twf.pack_attr_table(tscenes.get("first").scene)
    assert tuple(empty.shape) == (1, 16) and not empty.any()


def test_registry_has_the_mesh_scenes():
    assert set(MESH_SCENES) <= set(tscenes.names())
