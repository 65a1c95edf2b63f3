"""The hit kernel's triangle tier in its plain version, against the JAX
package on the CPU.

`hit_reference` (what `Tracer.hit` runs on CPU tensors) against the Pallas
hit kernel through the pinned golden `mesh_hit.npz` (4,096 camera rays of
the small mesh scene, a 16 x 16 UV sphere of 512 triangles on the
backpack's ground sphere, and one bounce of them; made by
`tools/make_torch_goldens.py`):

- the packed words equal on every lane, bit 20 (a triangle won) included;
- a triangle winner's original id (`tri_perm[slot]`) equals the Pallas
  kernel's, except where the ray crosses an edge that two triangles share:
  both are hit at one t and the first in the walk's order wins, the port
  following each ray's own octant threading and the Pallas kernel its
  packet's majority octant; there t must agree under the float rule;
- the floats (p, u, v, normal) under `cuda_trace.hit_agreement`'s rule (XLA
  on the CPU contracts multiply-adds into FMAs; Moller-Trumbore is dot and
  cross products).

Against the XLA engine's `closest_hit` on the same rays (stored beside the
golden): the same lanes hit, the same material, the triangle's normal after
the wavefront's resolve.  `tri_walk_reference` keeps the dense winner of
every triangle, counts its tests, and its two threadings agree.  The
Pallas kernel itself runs here on 256 rays of `triangles`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.engine import wavefront as jwf
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu_torch.engine import wavefront as twf
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
PLANES = ("p", "u", "v", "normal")
T_MIN = ct._f32(0.001)


def mesh_scene():
    """The golden's small mesh scene (`make_torch_goldens.mesh_scene`)."""
    return tscenes.backpack_standin((16, 16)).scene


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(DATA, "mesh_hit.npz"))


@pytest.fixture(scope="module")
def tracer():
    return ct.Tracer(mesh_scene(), "cpu")


def _rays(g, b):
    return [torch.from_numpy(np.array(g[f"{k}{b}"]))
            for k in ("o", "d", "tm", "alive")]


@pytest.fixture(scope="module")
def hits(golden, tracer):
    return [tracer.hit(*_rays(golden, b)) for b in range(2)]


def test_slot_map_equals_the_golden(golden, tracer):
    np.testing.assert_array_equal(tracer.bake.tri_perm, golden["perm"])
    assert tracer.supports_hit and tracer.bake.features() & ct.FEAT_TRI_BVH


@pytest.mark.parametrize("bounce", [0, 1])
def test_tri_tier_matches_pallas_golden(golden, tracer, hits, bounce):
    g, got = golden, hits[bounce]
    want = [g[f"{k}{bounce}"] for k in ("packed",) + PLANES]
    res = ct.hit_agreement(got, want)
    assert res["packed_equal"] and res["within_limits"], res
    assert res["frac_close"] >= 0.99, res
    alive = g[f"alive{bounce}"]
    tri = ((g[f"packed{bounce}"] >> 20) & 1).astype(bool)
    assert tri.sum() > (500 if bounce == 0 else 10)
    assert not (tri & ~alive).any()
    perm = g["perm"]
    ids_got = perm[got.slot.numpy().astype(np.int64)[tri]]
    ids_want = perm[g[f"slot{bounce}"].astype(np.int64)[tri]]
    assert (ids_got >= 0).all() and (ids_want >= 0).all()
    # a lane whose id differs crossed a shared edge: the same t
    other = ids_got != ids_want
    t_err = np.abs(got.p.numpy() - g[f"p{bounce}"]).max(-1)[tri][other]
    assert (t_err <= ct.HIT_CLOSE).all(), (other.sum(), t_err)
    assert other.mean() <= 0.01, other.mean()
    for k in PLANES + ("slot",):  # a dead lane is all zeros
        assert not getattr(got, k).numpy()[~alive].any(), k
    assert not got.slot.numpy()[~tri].any()  # slot only where one won


@pytest.mark.parametrize("bounce", [0, 1])
def test_tri_tier_matches_closest_hit(golden, tracer, hits, bounce):
    """Against the XLA engine's closest_hit: after the resolve (one gather of
    the slot-attribute table) the same lanes hit the same material, at the
    same point, with the same faced normal, under test_regen.py's
    tolerances."""
    g, got = golden, hits[bounce]
    o, d, tm, alive = _rays(g, bounce)
    attr = twf.pack_attr_table(mesh_scene(), tracer.bake.tri_perm)
    rec = twf.resolve_hit_packed(attr, *got, d)
    hit = rec.hit.numpy()
    np.testing.assert_array_equal(hit, g[f"ref_hit{bounce}"] & alive.numpy())
    same = rec.mat_id.numpy()[hit] == g[f"ref_mat{bounce}"][hit]
    assert same.all()
    np.testing.assert_allclose(rec.p.numpy()[hit], g[f"ref_p{bounce}"][hit],
                               atol=5e-3)
    np.testing.assert_allclose(rec.normal.numpy()[hit],
                               g[f"ref_normal{bounce}"][hit], atol=3e-2)


def test_resolve_equals_jax_on_triangle_winners(golden, tracer, hits):
    """The port's resolve of its own hit outputs against the JAX package's
    resolve of the same outputs, with the JAX attribute table."""
    got = hits[0]
    d = _rays(golden, 0)[1]
    jsd_attr = jwf.pack_attr_table(_jax_mesh_scene(), golden["perm"])
    want = jwf.resolve_hit_packed(jsd_attr, *(jnp.asarray(x.numpy())
                                              for x in got), jnp.asarray(d))
    rec = twf.resolve_hit_packed(
        twf.pack_attr_table(mesh_scene(), tracer.bake.tri_perm), *got, d)
    for f in rec._fields:
        a, b = getattr(rec, f).numpy(), np.asarray(getattr(want, f))
        if f == "normal":
            np.testing.assert_allclose(a, b, rtol=2e-6, atol=2e-7)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _jax_mesh_scene():
    from raytracing_gpu_tpu.scene.builder import SceneBuilder as JaxBuilder

    b = JaxBuilder(background=(0.7, 0.8, 1.0))
    tex = b.solid((0.8, 0.2, 0.2))
    v, f, uvs, n = jscenes._uv_sphere(16, 16)
    v = v * 0.45
    v[:, 1] += 0.45
    b.mesh(v, f, b.lambertian(tex), uvs=uvs, normals=n)
    b.sphere((0, -100, -1), 100, b.lambertian((0, 1, 0)))
    return b.build()


@pytest.mark.parametrize("octant", [False, True])
def test_walk_keeps_the_dense_winner(golden, tracer, octant):
    """Both threadings against every triangle of the mesh tested densely:
    the same winning distance on every lane, and the same triangle except
    across a shared edge."""
    o, d, tm, alive = _rays(golden, 0)
    o3, d3 = tuple(o.unbind(1)), tuple(d.unbind(1))
    bake = tracer.bake
    big = torch.full_like(tm, ct.BIG)
    walk = ct.tri_walk_reference(bake, o3, d3, T_MIN, big, alive, octant)
    geom = torch.from_numpy(bake.tri_geom if octant
                            else bake.tri_table[:, :9].copy())
    col = (lambda x: x[:, None])
    t, _, _, ok = ct.tri_candidates(geom[None], tuple(map(col, o3)),
                                    tuple(map(col, d3)), T_MIN)
    t = torch.where(ok & alive[:, None], t, ct.BIG)
    dense_t, dense_row = t.min(dim=1)
    hit = dense_t < ct.BIG * 0.5
    assert int(hit.sum()) > 500
    assert torch.equal(walk.better, hit)
    assert torch.equal(walk.t[hit], dense_t[hit])
    ids = bake.tri_perm if octant else bake.tri_ids
    same = ids[walk.row[hit].numpy()] == ids[dense_row[hit].numpy()]
    assert same.mean() >= 0.99, same.mean()
    # a small part of the tree: nodes and candidates per live ray
    live = int(alive.sum())
    n_nodes = len(bake.tri_hit_nodes if octant else bake.tri_nodes)
    assert 0 < walk.nodes.sum() / live < n_nodes
    # a tested leaf counts exactly its real slots (pads never hit): fewer
    # than whole leaves where the leaves hold pads
    leaf_k = ct.HIT_TRI_LEAF_K if octant else ct.TRI_LEAF_K
    real = bake.tri_hit_leaf_count() if octant else bake.tri_leaf_count()
    tests = walk.leaf_tests.numpy()
    assert tests.sum() > 0 and (tests[real == 0] == 0).all()
    assert int(walk.rows.sum()) == int((tests * real).sum())
    pads = ((tests > 0) & (real > 0) & (real < leaf_k)).any()
    assert (int(walk.rows.sum()) < leaf_k * int(tests.sum())) == pads
    assert int(walk.nodes[~alive].sum()) == 0


@pytest.mark.parametrize("octant", [False, True])
def test_walk_reads_what_it_tests(golden, tracer, octant):
    """The walk's read masks (`tri_reads`, the bounds' bytes) agree with
    its counts: every node tested follows one link column, the leaves
    tested are at most the leaf visits, and the winners are the rows (or
    slots) the lanes keep."""
    o, d, tm, alive = _rays(golden, 1)
    o3, d3 = tuple(o.unbind(1)), tuple(d.unbind(1))
    bake = tracer.bake
    leaf_k = ct.HIT_TRI_LEAF_K if octant else ct.TRI_LEAF_K
    n_rows = len(bake.tri_geom if octant else bake.tri_table)
    walk = ct.tri_walk_reference(bake, o3, d3, T_MIN,
                                 torch.full_like(tm, ct.BIG), alive, octant)
    reads = ct.tri_reads(walk, n_rows)
    assert bool(reads["nodes"][0]) and torch.equal(reads["links"].any(1),
                                                   reads["nodes"])
    assert 0 < int(reads["nodes"].sum()) <= int(walk.nodes.sum())
    assert len(reads["leaves"]) * leaf_k == n_rows
    ids = bake.tri_perm if octant else bake.tri_ids
    real = torch.from_numpy((ids.reshape(-1, leaf_k) >= 0).sum(1))
    assert 0 < int(real[reads["leaves"]].sum()) <= int(walk.rows.sum())
    won = torch.unique(walk.row[walk.better])
    assert torch.equal(torch.nonzero(reads["won"])[:, 0], won)
    assert bool(reads["leaves"][won // leaf_k].all())
    assert ct.merge_reads(None, reads) is reads
    assert ct.merge_reads(None, None) is None
    assert all(torch.equal(v, reads[k])
               for k, v in ct.merge_reads(reads, reads).items())


def test_degenerate_triangles_never_hit():
    """The pole triangles of a UV sphere have a zero-length edge: their
    determinant is 0 whatever the ray, so the 1e-7 cut rejects them, and a
    ray that grazes them meets the neighbouring triangle instead."""
    v, f, _, _ = tscenes._uv_sphere(16, 16)
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    degen = np.linalg.norm(np.cross(e1, e2), axis=1) < 1e-9
    assert degen.sum() == 32
    g = torch.from_numpy(np.concatenate([v[f[:, 0]], e1, e2], axis=1)
                         [degen].astype(np.float32))
    rng = np.random.default_rng(5)
    n = 512
    o = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 2)
    tgt = torch.from_numpy(np.float32([0.0, 1.0, 0.0]) + rng.normal(
        size=(n, 3)).astype(np.float32) * 0.01)
    d = tgt - o
    col = (lambda x: x[:, None])
    _, _, _, ok = ct.tri_candidates(g[None], tuple(map(col, o.unbind(1))),
                                    tuple(map(col, d.unbind(1))), T_MIN)
    assert not ok.any()


def test_tri_tier_matches_pallas_live_on_triangles():
    """The Pallas hit kernel itself (interpret mode, sub 8) on 256 camera
    rays of `triangles` (one leaf of 4 triangles)."""
    jsd = jscenes.get("triangles")
    rng = np.random.default_rng(3)
    n = 256
    o, d, tm = jsd.camera.get_rays(
        jax.random.PRNGKey(1), jnp.asarray(rng.random(n, np.float32)),
        jnp.asarray(rng.random(n, np.float32)))
    alive = rng.random(n) > 0.1
    jtr = pt.PallasTracer(jsd.scene)
    want = jtr.hit(o, d, tm, jnp.asarray(alive), sub=8)
    tr = ct.Tracer(tscenes.get("triangles").scene, "cpu")
    got = tr.hit(*(torch.from_numpy(np.array(x)) for x in (o, d, tm, alive)))
    res = ct.hit_agreement(got, [np.asarray(x) for x in want[:5]])
    assert res["packed_equal"] and res["within_limits"], res
    tri = ((np.asarray(want[0]) >> 20) & 1).astype(bool)
    assert tri.sum() >= 10
    np.testing.assert_array_equal(
        tr.bake.tri_perm[got.slot.numpy().astype(np.int64)[tri]],
        np.asarray(jtr.bake.tri_perm)[np.asarray(want[5]).astype(
            np.int64)[tri]])
