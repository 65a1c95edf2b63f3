"""The sphere BVH of the port against the JAX package, on the CPU.

- `accel.bvh.build` (the port's own copy of the binned-SAH builder) equals
  `raytracing_gpu_tpu.accel.bvh.build(backend="native")` node for node, on
  big_scene1's sphere bounds and on random boxes from a numpy seed.  Both
  compile the same source with the same flags on the same host, so the
  topology is equal here; across hosts `-march=native` may change it.
- big_scene1's scene tables equal the JAX builder's host snapshot, and the
  kernel bake (the leaf-contiguous sphere table, nodes, links, leaf starts,
  the hit kernel's octant nodes) and the wavefront's world bounds equal the
  JAX bake and tracer's, bit for bit.
- The kernels' walk (`sphere_walk_reference`, both link sets) keeps the
  dense loop's winner on the pinned hit golden's rays, and the plain forward
  version meets the dense scenes' golden rule on `big_scene1_32.npz`.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.accel import bvh as jbvh
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu_torch import RenderSettings, compile_renderer
from raytracing_gpu_tpu_torch import native
from raytracing_gpu_tpu_torch.accel import bvh as tbvh
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct
from raytracing_gpu_tpu_torch.scene import types as tst

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
TABLES = sorted(tst.TABLES)
FIELDS = ("node_min", "node_max", "hit_link", "miss_link", "leaf_prims")
T_MIN = np.float32(0.001)


@pytest.fixture(scope="module")
def big():
    jsd, tsd = jscenes.get("big_scene1"), tscenes.get("big_scene1")
    return jsd, tsd, pt.PallasTracer(jsd.scene), ct.Tracer(tsd.scene, "cpu")


def _sphere_bounds(table):
    c0, c1, r = table[:, 0:3], table[:, 3:6], np.abs(table[:, 8:9])
    return np.minimum(c0, c1) - r, np.maximum(c0, c1) + r


def _random_boxes(seed, n):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    return lo, lo + rng.uniform(0.01, 2, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("case,leaf", [("big_scene1", 8), ("random7", 4),
                                       ("random8", 8), ("one", 8)])
def test_flat_bvh_equals_jax_native_builder(big, case, leaf):
    if case == "big_scene1":
        rows = np.asarray(big[3].bake.sphere_table)
        lo, hi = _sphere_bounds(rows[np.abs(rows[:, 8]) > 0])
    elif case == "one":
        lo, hi = _random_boxes(3, 1)
    else:
        lo, hi = _random_boxes(int(case[-1]), 300)
    mine = tbvh.build(lo, hi, leaf_size=leaf)
    theirs = jbvh.build(lo, hi, leaf_size=leaf, backend="native")
    for f in FIELDS:
        a, b = getattr(mine, f), np.asarray(getattr(theirs, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)  # exact
    assert mine.leaf_prims.shape[1] == leaf


def test_bvh_build_refuses_no_primitives():
    with pytest.raises(ValueError, match="at least one"):
        tbvh.build(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))


def test_builder_compile_failure_raises_with_the_compiler_message(
        monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "out" / "lib.so"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError,
                       match=r"(?s)BVH builder build failed.*error:"):
        native.get_lib()


@pytest.mark.parametrize("table", TABLES)
def test_big_scene1_tables_equal_jax_host_snapshot(big, table):
    jsd, tsd = big[0], big[1]
    a, b = getattr(jsd.scene._host_np, table), getattr(tsd.scene, table)
    for f in dataclasses.fields(b):
        x, y = np.asarray(getattr(a, f.name)), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, (table, f.name)
        np.testing.assert_array_equal(y, x, err_msg=f"{table}.{f.name}")
    np.testing.assert_array_equal(tsd.scene.background,
                                  np.asarray(jsd.scene._host_np.background))
    assert tsd.aspect == jsd.aspect


@pytest.mark.parametrize("field,shape", [
    ("sphere_table", (672, 24)), ("sph_nodes", (167, 6)),
    ("sph_links", (167, 2)), ("sph_start", (167, 1)),
    ("sph_hit_nodes", (167, 23))])
def test_big_scene1_bake_equals_jax(big, field, shape):
    jb, tb = big[2].bake, big[3].bake
    a, b = np.asarray(getattr(jb, field)), getattr(tb, field)
    assert b.shape == shape and a.dtype == b.dtype, (a.shape, a.dtype)
    np.testing.assert_array_equal(b, a)  # exact


def test_big_scene1_tracer_fields_equal_jax(big):
    jtr, ttr = big[2], big[3]
    assert ttr.supports_hit and jtr.supports_hit
    for mine, theirs in ((ttr.world_lo, jtr.world_lo),
                         (ttr.world_hi, jtr.world_hi)):
        assert mine.dtype == np.float32
        np.testing.assert_array_equal(mine, np.asarray(theirs))
    assert ttr.bake.features() == ct.FEAT_SPHERE_BVH | ct.FEAT_CHECKER
    # a pad row of a part-full leaf is all zeros: radius 0 never hits
    pad = np.abs(ttr.bake.sphere_table[:, 8]) == 0
    assert pad.sum() == 672 - 484
    assert not ttr.bake.sphere_table[pad].any()


@pytest.mark.parametrize("octant", [False, True])
def test_threadings_visit_every_node_once_in_preorder(big, octant):
    """Descending everywhere (hit links), each threading of the tree visits
    all nodes once, parents before children, and misses skip a subtree."""
    bake = big[3].bake
    m = len(bake.sph_nodes)
    links = (bake.sph_hit_nodes[:, 7:].astype(np.int64) if octant
             else bake.sph_links.astype(np.int64))
    for o in range(8 if octant else 1):
        hit, miss = links[:, 2 * o], links[:, 2 * o + 1]
        order, node = [], 0
        while node >= 0:
            order.append(node)
            node = int(hit[node])
        assert sorted(order) == list(range(m)) and order[0] == 0
        pos = np.empty(m, np.int64)
        pos[order] = np.arange(m)
        # a miss link jumps past the node's whole subtree, forwards only
        later = miss >= 0
        assert (pos[miss[later]] > pos[np.nonzero(later)[0]]).all()


@pytest.mark.parametrize("bounce", [0, 1])
@pytest.mark.parametrize("octant", [False, True])
def test_walk_keeps_the_dense_winner(big, bounce, octant):
    g = np.load(os.path.join(DATA, "big_scene1_hit.npz"))
    bake = big[3].bake
    o, d, tm, alive = (torch.from_numpy(g[f"{k}{bounce}"])
                       for k in ("o", "d", "tm", "alive"))
    o3, d3 = tuple(o.unbind(1)), tuple(d.unbind(1))
    t_best = torch.full_like(tm, ct.BIG)
    dense = ct._closest_sphere(bake.sphere_table, o3, d3, tm, float(T_MIN),
                               t_best)
    walk = ct.sphere_walk_reference(bake, o3, d3, tm, float(T_MIN), t_best,
                                    alive, octant)
    hit = dense.better & alive
    assert int(hit.sum()) > 1000
    assert torch.equal(walk.better, hit)
    assert torch.equal(walk.t[hit], dense.t[hit])
    assert torch.equal(walk.row[hit], dense.row[hit])
    # the walk tests a small part of the tree: on these rays about 18-20
    # nodes and 15-25 rows per live ray, of 167 nodes and 672 rows
    live = alive.sum()
    assert 0 < walk.nodes.sum() / live < 40 and 0 < walk.rows.sum() / live < 60
    assert int(walk.nodes[~alive].sum()) == 0


def test_big_scene1_chunk_matches_pinned_golden():
    """The megakernel route's plain version (dense rows over the
    leaf-contiguous table) against the JAX megakernel's chunk, under the
    dense scenes' golden rule (tests/test_torch_spheres.py)."""
    g = np.load(os.path.join(DATA, "big_scene1_32.npz"))
    st = RenderSettings(image_width=int(g["image_width"]),
                        aspect_ratio=float(g["aspect_ratio"]),
                        spp_per_chunk=int(g["spp_per_chunk"]), num_chunks=1,
                        max_depth=int(g["max_depth"]),
                        ray_batch=int(g["ray_batch"]), t_min=float(g["t_min"]))
    tsd = tscenes.get("big_scene1")
    chunk = compile_renderer(tsd.scene, tsd.camera, st, device="cpu")
    assert chunk.engine_name == "megakernel"
    got = chunk(int(g["base"])).numpy().astype(np.float64)
    want = g["sums"].astype(np.float64)
    assert got.shape == want.shape == (576, 3) and np.isfinite(got).all()
    within = (np.abs(got - want) <= 1e-3 * np.abs(want).max()).all(-1).mean()
    assert within >= 0.99, within
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=3e-3)


def test_plain_forward_counts_the_walk(big):
    tsd, tracer = big[1], big[3]
    counts = {}
    # the middle rows: the top of the image is sky and tests no leaf
    out = ct.trace_pixels_reference(tracer.bake, tsd.camera, 450, 800,
                                    800 * 225, 512, 77, 4, counts=counts)
    assert out.shape == (512, 3) and torch.isfinite(out).all()
    assert counts["live"] >= 512 and counts["cont"] < counts["live"]
    assert 0 < counts["nodes"] < 40 * counts["live"]
    # a tested leaf counts exactly its real rows (pads never hit); a
    # quarter of big_scene1's rows are pads, so that is fewer than whole
    # leaves
    tests = counts["leaf_tests"].numpy()
    real = tracer.bake.sph_leaf_count()
    assert tests.sum() > 0 and (tests[real == 0] == 0).all()
    assert counts["rows"] == int((tests * real).sum())
    assert counts["rows"] < ct.SPH_LEAF_K * int(tests.sum())
    assert set(counts["scatter"]) <= {tst.LAMBERTIAN, tst.METAL,
                                      tst.DIELECTRIC}
