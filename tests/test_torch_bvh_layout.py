"""The BVH tables as the kernels read them, and the tie rule of the walks.

`cuda_trace.device_tables` turns the bake into 16-byte records: a node is
two float4s (lo xyz and the leaf's first row as int32 bits; hi xyz and its
count of real rows), the (hit, miss) links are int2 pairs, a hit-tier
triangle slot is v0 e1 e2 and three zeros.  These tests hold the records
to the bake they come from (exactly), the pads of every leaf to its tail
(so that a leaf's count is where its real rows end), and the walks to the
rule the kernels keep on exact ties: the first row in the ray's own visit
order, which is the lowest slot of the first leaf that holds the nearest
distance.  The tie scene (`models.probes.tie_mesh`) duplicates one triangle
into two slots of one leaf and another into leaves of its own; a serial
walk of each ray, written here with scalar float32 node tests and a loop
over the leaf's slots in order, is the reference.
"""

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu_torch import Camera, SceneBuilder
from raytracing_gpu_tpu_torch.models import probes, scenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct

T_MIN = ct._f32(0.001)


def _scene(name):
    if name == "mesh":
        return scenes.backpack_standin((16, 16)).scene
    if name == "tie":
        return probes.tie_mesh(SceneBuilder, Camera)[0]
    return scenes.get(name).scene


@pytest.fixture(scope="module", params=["triangles", "mesh", "big_scene1",
                                        "tie"])
def baked(request):
    bake = ct.bake_scene(_scene(request.param))
    return request.param, bake, ct.device_tables(bake)


def _decode(rec):
    """(bounds (M, 6), first row (M,), count (M,)) of node records."""
    ints = rec.view(np.int32)
    return np.concatenate([rec[:, 0:3], rec[:, 4:7]], axis=1), ints[:, 3], \
        ints[:, 7]


def test_records_decode_to_the_bake(baked):
    name, bake, dt = baked
    for key, cols in (("sph_nodes", 8), ("tri_nodes", 8), ("tri_slots", 12),
                      ("tri_slot_nodes", 8), ("sph_octant_links", 16),
                      ("tri_slot_links", 16), ("sph_links", 2),
                      ("tri_links", 2)):
        t = dt[key]
        assert t.shape[1] == cols and t.flags.c_contiguous, key
        assert t.dtype.itemsize * cols % (16 if cols > 2 else 8) == 0, key
    bounds, first, count = _decode(dt["sph_nodes"])
    np.testing.assert_array_equal(bounds, bake.sph_nodes)
    np.testing.assert_array_equal(first, bake.sph_start[:, 0])
    np.testing.assert_array_equal(dt["sph_links"], bake.sph_links)
    # the hit kernel's 23 columns, rebuilt from the records and link pairs
    np.testing.assert_array_equal(
        np.concatenate([bounds, first[:, None].astype(np.float32),
                        dt["sph_octant_links"].astype(np.float32)], axis=1),
        bake.sph_hit_nodes)
    bounds, first, _ = _decode(dt["tri_nodes"])
    np.testing.assert_array_equal(bounds, bake.tri_nodes)
    np.testing.assert_array_equal(first, bake.tri_start[:, 0])
    np.testing.assert_array_equal(dt["tri_links"], bake.tri_links)
    bounds, first, _ = _decode(dt["tri_slot_nodes"])
    np.testing.assert_array_equal(
        np.concatenate([bounds, first[:, None].astype(np.float32),
                        dt["tri_slot_links"].astype(np.float32)], axis=1),
        bake.tri_hit_nodes)
    np.testing.assert_array_equal(dt["tri_slots"][:, :9], bake.tri_geom)
    assert not dt["tri_slots"][:, 9:].any()
    # a sphere row (96 bytes) and a megakernel triangle row (160) are
    # whole 16-byte words, so their geometry is three float4 loads
    assert ct.SPHERE_COLS * 4 % 16 == 0 and ct.TRI_COLS * 4 % 16 == 0
    assert name != "big_scene1" or len(bake.sph_nodes) == 167


def _leaves(rec, real, leaf_k):
    """(first row, count, the leaf's real flags) of each leaf node."""
    _, first, count = _decode(rec)
    leaf = first >= 0
    assert (count[~leaf] == 0).all()
    return [(int(s), int(c), real[s:s + leaf_k])
            for s, c in zip(first[leaf], count[leaf])]


def test_pads_sit_at_each_leafs_tail(baked):
    name, bake, dt = baked
    tiers = [(dt["tri_nodes"], bake.tri_ids >= 0, bake.tri_table,
              ct.TRI_LEAF_K),
             (dt["tri_slot_nodes"], bake.tri_perm >= 0, bake.tri_geom,
              ct.HIT_TRI_LEAF_K)]
    if len(bake.sph_nodes):
        tiers.append((dt["sph_nodes"], bake.sphere_table[:, 8] != 0,
                      bake.sphere_table, ct.SPH_LEAF_K))
    for rec, real, table, leaf_k in tiers:
        if not len(rec):  # no triangles
            continue
        leaves = _leaves(rec, real, leaf_k)
        assert sum(c for _, c, _ in leaves) == int(real.sum()) > 0
        assert len(leaves) * leaf_k == len(table)
        for s, c, flags in leaves:
            assert 0 < c <= leaf_k
            assert flags[:c].all() and not flags[c:].any(), (name, s)
            assert not table[s + c:s + leaf_k].any()  # a pad is all zeros


def _serial_walk(bake, o, d, octant, cand_t, cand_ok):
    """One ray's walk, node by node in float32 scalars, the leaf's slots in
    order with a strict `<`: (winning row or slot, -1 on a miss; its t).
    `cand_t`, `cand_ok` are the ray's Moller-Trumbore results per row."""
    f32 = np.float32
    if octant:
        hn = bake.tri_hit_nodes
        bounds, start = hn[:, :6], hn[:, 6].astype(np.int64)
        oct_ = 4 * int(d[0] < 0) + 2 * int(d[1] < 0) + int(d[2] < 0)
        links = hn[:, 7 + 2 * oct_:9 + 2 * oct_].astype(np.int64)
        real, leaf_k = bake.tri_perm >= 0, ct.HIT_TRI_LEAF_K
    else:
        bounds, start = bake.tri_nodes, bake.tri_start[:, 0].astype(np.int64)
        links = bake.tri_links.astype(np.int64)
        real, leaf_k = bake.tri_ids >= 0, ct.TRI_LEAF_K
    eps = f32(1e-12)
    iv = [f32(1.0) / (x if abs(x) >= eps else (eps if x >= 0 else -eps))
          for x in d]
    best_t, best = f32(ct.BIG), -1
    node = 0
    while node >= 0:
        near, far = [], []
        for k in range(3):
            t0 = (bounds[node, k] - o[k]) * iv[k]
            t1 = (bounds[node, 3 + k] - o[k]) * iv[k]
            near.append(min(t0, t1))
            far.append(max(t0, t1))
        tn, tf = max(near), min(far)
        hit = tf >= max(tn, T_MIN) and tn <= best_t
        if hit and start[node] >= 0:
            for s in range(start[node], start[node] + leaf_k):
                if real[s] and cand_ok[s] and cand_t[s] < best_t:
                    best_t, best = cand_t[s], s
        node = int(links[node, 0 if hit else 1])
    return best, best_t


def _tie_rays(n=384, seed=7):
    """Rays at the tie scene from the camera's side and from behind its
    two triangles (other direction octants), made with numpy."""
    rng = np.random.default_rng(seed)
    half = n // 2
    o = np.zeros((n, 3), np.float32)
    o[:half] = (0.0, 0.0, 6.0)
    o[half:] = (0.0, 0.0, -1.5)
    aim = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    np.full(n, 0.25)], axis=1).astype(np.float32)
    d = (aim - o).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("octant", [False, True])
def test_ties_keep_the_first_in_visit_order(octant):
    scene = probes.tie_mesh(SceneBuilder, Camera)[0]
    bake = ct.bake_scene(scene)
    o, d = _tie_rays()
    n = len(o)
    o3, d3 = tuple(o.unbind(1)), tuple(d.unbind(1))
    alive = torch.ones(n, dtype=torch.bool)
    tm = torch.zeros(n)
    big = torch.full((n,), ct.BIG)
    walk = ct.tri_walk_reference(bake, o3, d3, T_MIN, big, alive, octant)
    geom = torch.from_numpy(bake.tri_geom if octant
                            else np.ascontiguousarray(bake.tri_table[:, :9]))
    col = (lambda x: x[:, None])
    t, _, _, ok = ct.tri_candidates(geom[None], tuple(map(col, o3)),
                                    tuple(map(col, d3)), T_MIN)
    ids = bake.tri_perm if octant else bake.tri_ids
    on_a = on_b = 0
    for i in range(n):
        row, t_i = _serial_walk(bake, o[i].numpy(), d[i].numpy(), octant,
                                t[i].numpy(), ok[i].numpy())
        assert int(walk.row[i]) == row, i
        assert bool(walk.better[i]) == (row >= 0)
        if row < 0:
            continue
        assert float(walk.t[i]) == float(t_i)
        # every copy of the winner that the ray meets ties with it
        copies = np.nonzero((ids >= 0) & ok[i].numpy()
                            & (t[i].numpy() == t_i))[0]
        if int(ids[row]) in (2, 3):
            on_a += 1
            assert len(copies) == 2 and row == copies.min()  # one leaf
        elif int(ids[row]) >= 4:
            on_b += 1
            assert len(copies) == 40
    assert on_a > 20 and on_b > 20, (on_a, on_b)
    if octant:  # the hit kernel's plain version keeps the same slot
        hr = ct.hit_reference(bake, o.contiguous(), d.contiguous(), tm,
                              alive)
        tri = ((hr.packed >> 20) & 1).bool()
        assert torch.equal(tri, walk.better)
        assert torch.equal(hr.slot[tri], walk.row[tri].float())
