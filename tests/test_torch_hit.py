"""The pure closest-hit kernel's plain version and the wavefront glue around
it, against the JAX package on the CPU.

`hit_reference` (what `Tracer.hit` runs on CPU tensors) against the Pallas
hit kernel `PallasTracer.hit`: on big_scene1 through the pinned golden
`big_scene1_hit.npz` (4,096 camera rays and one bounce of them; the Pallas
kernel in interpret mode is too slow for tier 1 at that size), on `first`
(the dense sphere loop) and `cornell_box` (rects and boxes) live on 256
rays.  The rule: the packed words equal on every lane, and on hit lanes p
within 5e-3, the normal within 3e-2, u and v within 1e-2 (u modulo 1), and
>= 99% of hit lanes within 2e-3 in every output.  Not bit for bit: XLA on
the CPU contracts a * b + c into one FMA (14% of float32 x * y + z differ
from the twice-rounded result) and rounds 1 / sqrt differently, and the
sphere quadratic's cancellation (r = 0.2 spheres ~13 units away) turns one
ulp of hb * hb - a * cc into up to ~1e-3 of t.  The limits are the JAX
package's own for the same cause (tests/test_regen.py:151-156).

Against the XLA engine's `closest_hit` under test_regen.py's tolerances;
`_sort_keys` and `resolve_hit_packed` equal JAX's; `materials.scatter` fed
JAX's own four draws agrees with JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.core import rng as jrng
from raytracing_gpu_tpu.engine import wavefront as jwf
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu.scene import materials as jmat
from raytracing_gpu_tpu_torch.core import rng as trng
from raytracing_gpu_tpu_torch.engine import diff
from raytracing_gpu_tpu_torch.engine import wavefront as twf
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct
from raytracing_gpu_tpu_torch.scene import materials as tmat

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
PLANES = ("p", "u", "v", "normal")


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(DATA, "big_scene1_hit.npz"))


@pytest.fixture(scope="module")
def big_tracer():
    return ct.Tracer(tscenes.get("big_scene1").scene, "cpu")


def _rays(g, b):
    return [torch.from_numpy(np.array(g[f"{k}{b}"]))
            for k in ("o", "d", "tm", "alive")]


def assert_hits_match(got: ct.HitResult, want: dict, alive: np.ndarray):
    """The rule of the module docstring (`cuda_trace.hit_agreement`);
    `want` maps packed/p/u/v/normal to the Pallas kernel's outputs."""
    res = ct.hit_agreement(got, [want[k] for k in ("packed",) + PLANES])
    assert res["packed_equal"] and res["within_limits"], res
    assert res["frac_close"] >= 0.99, res
    hit = ((want["packed"] >> 16) & 1).astype(bool)
    assert not (hit & ~alive).any()
    for k in PLANES + ("slot",):  # a dead lane is all zeros; no triangles
        a = getattr(got, k).numpy()
        assert not a[~alive].any(), k
    assert not got.slot.numpy().any()


@pytest.mark.parametrize("bounce", [0, 1])
def test_hit_matches_pallas_golden(golden, big_tracer, bounce):
    g = golden
    o, d, tm, alive = _rays(g, bounce)
    before = ct.Tracer.hit_launches
    got = big_tracer.hit(o, d, tm, alive)
    assert ct.Tracer.hit_launches == before  # the CPU runs the plain version
    assert_hits_match(got, {k: g[f"{k}{bounce}"] for k in
                            ("packed",) + PLANES}, g[f"alive{bounce}"])
    hits = int(((g[f"packed{bounce}"] >> 16) & 1).sum())
    assert hits > (1000 if bounce else 2500)
    assert ((got.packed.numpy() >> 21) & 1).sum() == hits  # all spheres


@pytest.mark.parametrize("bounce", [0, 1])
def test_hit_matches_closest_hit(golden, big_tracer, bounce):
    """Against the XLA engine's closest_hit under test_regen.py's limits.
    After a bounce the two disagree on the winner of 3 of 1,304 rays that
    leave a surface (a sphere hit again just past t_min), and the Pallas
    kernel does too: at most 0.5% of hit lanes may differ there."""
    g = golden
    o, d, tm, alive = _rays(g, bounce)
    got = big_tracer.hit(o, d, tm, alive)
    hit = ((got.packed.numpy() >> 16) & 1).astype(bool)
    np.testing.assert_array_equal(hit, g[f"ref_hit{bounce}"]
                                  & g[f"alive{bounce}"])
    same = (got.packed.numpy() & 0xFFFF)[hit] == g[f"ref_mat{bounce}"][hit]
    assert same.mean() >= (1.0 if bounce == 0 else 0.995), same.mean()
    np.testing.assert_allclose(got.p.numpy()[hit][same],
                               g[f"ref_p{bounce}"][hit][same], atol=5e-3)
    np.testing.assert_allclose(got.normal.numpy()[hit][same],
                               g[f"ref_normal{bounce}"][hit][same], atol=3e-2)


@pytest.mark.parametrize("name", ["first", "cornell_box"])
def test_hit_matches_pallas_on_dense_scenes(name):
    jsd = jscenes.get(name)
    rng = np.random.default_rng(3)
    n = 256
    o, d, tm = jsd.camera.get_rays(
        jax.random.PRNGKey(1), jnp.asarray(rng.random(n, np.float32)),
        jnp.asarray(rng.random(n, np.float32)))
    alive = rng.random(n) > 0.1
    want = pt.PallasTracer(jsd.scene).hit(o, d, tm, jnp.asarray(alive),
                                          sub=8)
    tracer = ct.Tracer(tscenes.get(name).scene, "cpu")
    assert tracer.supports_hit and not len(tracer.bake.sph_nodes)
    got = tracer.hit(*(torch.from_numpy(np.array(x))
                       for x in (o, d, tm, alive)))
    assert_hits_match(got, dict(zip(("packed",) + PLANES,
                                    (np.asarray(x) for x in want))), alive)
    assert ((got.packed.numpy() >> 16) & 1).sum() > 150


def test_hit_refuses_media_and_bad_inputs(big_tracer):
    smoke = ct.Tracer(tscenes.get("cornell_smoke").scene, "cpu")
    assert not smoke.supports_hit
    n = 8
    o, d = torch.zeros(n, 3), torch.ones(n, 3)
    tm, alive = torch.zeros(n), torch.ones(n, dtype=torch.bool)
    with pytest.raises(ValueError, match="no media"):
        smoke.hit(o, d, tm, alive)
    for bad in ((o.double(), d, tm, alive), (o, d[:4], tm, alive),
                (o, d, tm, alive.float()), (o.T.contiguous().T, d, tm, alive)):
        with pytest.raises(ValueError, match="must be a contiguous"):
            big_tracer.hit(*bad)


def test_sort_keys_equal_jax():
    rng = np.random.default_rng(11)
    n = 4096
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:16] = 0.0  # +0 goes to the positive octant
    alive = rng.random(n) > 0.3
    lo = np.array([-11, -1000, -11], np.float32)
    hi = np.array([12, 2.2, 11.5], np.float32)
    want = np.asarray(jwf._sort_keys(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(alive), jnp.asarray(lo),
                                     jnp.asarray(hi)))
    got = twf._sort_keys(*(torch.from_numpy(x) for x in (o, d, alive, lo,
                                                         hi)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the stable order of both argsorts is the same
    np.testing.assert_array_equal(
        torch.argsort(got, stable=True).numpy(),
        np.asarray(jnp.argsort(jnp.asarray(want))))


def test_resolve_hit_packed_equals_jax():
    """Random outputs of a hit kernel, triangle winners included (the
    resolve is generic; the port's attr table is the one zero row)."""
    rng = np.random.default_rng(12)
    n, s = 2048, 5
    attr = rng.normal(size=(s, 16)).astype(np.float32)
    attr[:, 15] = rng.integers(0, 9, s)
    packed = (rng.integers(0, 40, n) | (rng.integers(0, 2, n) << 16)
              | (rng.integers(0, 2, n) << 19) | (rng.integers(0, 2, n) << 20)
              ).astype(np.int32)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    u, v = rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    slot = rng.integers(-1, s + 1, n).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    args = (attr, packed, p, u, v, normal, slot, d)
    want = jwf.resolve_hit_packed(*(jnp.asarray(x) for x in args))
    got = twf.resolve_hit_packed(*(torch.from_numpy(x) for x in args))
    for f in got._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f == "normal":  # the unit() of a triangle's vertex normal
            np.testing.assert_allclose(a, b, rtol=2e-6, atol=2e-7)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    zero = twf.pack_attr_table(tscenes.get("big_scene1").scene)
    assert tuple(zero.shape) == (1, 16) and not zero.any()


@pytest.mark.parametrize("name", ["first", "cornell_smoke"])
def test_scatter_with_jax_draws_agrees(name):
    """`materials.scatter` fed the four draws that JAX's splits from its
    key.  `first` covers lambertian, metal and dielectric (big_scene1's
    kinds); cornell_smoke isotropic media and a light.  Directions within
    rtol 1e-5 + atol 1e-5 (XLA's FMA contraction and sqrt/rsqrt roundings;
    the unit-sphere radius is cbrt in JAX and a 1/3 power here), except
    where a dielectric's Schlick test lies within that of its draw and the
    two take the other branch (at most 0.1% of lanes); attenuation and
    emission within 1e-6."""
    jsd, tsd = jscenes.get(name), tscenes.get(name)
    rng = np.random.default_rng(21)
    n = 4096
    n_mat = len(tsd.scene.materials.kind)
    mat = rng.integers(0, n_mat, n).astype(np.int32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    front = (d * nrm).sum(1) < 0
    nrm = np.where(front[:, None], nrm, -nrm).astype(np.float32)
    p = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    u, v = rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)
    key = jax.random.PRNGKey(7)
    k_unit, k_sphere, k_iso, k_refl = jax.random.split(key, 4)
    draws = tmat.ScatterDraws(*(torch.from_numpy(np.array(x)) for x in (
        jrng.unit_vector(k_unit, (n,)), jrng.in_unit_sphere(k_sphere, (n,)),
        jrng.in_unit_sphere(k_iso, (n,)), jrng.uniform(k_refl, (n,)))))
    args = (d, p, nrm, front, u, v, mat)
    want = jax.jit(lambda *a: jmat.scatter(jsd.scene, key, *a))(
        *(jnp.asarray(x) for x in args))
    got = tmat.scatter(tsd.scene, diff.get_params(tsd.scene, "cpu"), None,
                       *(torch.from_numpy(x) for x in args), draws=draws)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    for f in ("attenuation", "emitted"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-6)
    close = np.isclose(got.direction.numpy(), np.asarray(want.direction),
                       rtol=1e-5, atol=1e-5).all(-1)
    kinds = tsd.scene.materials.kind[mat]
    assert close[kinds != 2].all()
    assert close.mean() >= 0.999, close.mean()
    assert set(np.unique(kinds)) >= ({0, 1, 2} if name == "first"
                                     else {0, 3, 4})


def test_samplers_follow_the_reference_rules():
    gen = torch.Generator().manual_seed(5)
    n = 20000
    u = trng.uniform(gen, (n,), 2.0, 3.0)
    assert u.dtype == torch.float32 and 2.0 <= float(u.min()) < 3.0
    unit = trng.unit_vector(gen, (n,))
    assert torch.allclose(unit.norm(dim=-1), torch.ones(n), atol=1e-5)
    assert unit.mean(0).abs().max() < 0.03
    ball = trng.in_unit_sphere(gen, (n,))
    r = ball.norm(dim=-1)
    assert float(r.max()) <= 1.0 + 1e-6
    assert abs(float((r ** 3).mean()) - 0.5) < 0.02  # uniform in the ball
    disk = trng.in_unit_disk(gen, (n,))
    assert not disk[:, 2].any() and float(disk.norm(dim=-1).max()) <= 1.0
    assert abs(float((disk.norm(dim=-1) ** 2).mean()) - 0.5) < 0.02
    again = trng.unit_vector(torch.Generator().manual_seed(5), (4,))
    first = trng.unit_vector(torch.Generator().manual_seed(5), (4,))
    assert torch.equal(again, first)


def test_hit_reference_takes_the_octant_walks_winner(golden, big_tracer):
    """Under a sphere BVH the plain version walks as `rt_hit` does: with
    one leaf's box moved out of every ray's way (a node box a ray rounds
    out of, made certain), the spheres of that leaf are lost to the walk,
    and `hit_reference` returns the octant walk's winner, not the dense
    loop's."""
    bake = big_tracer.bake
    o, d, tm, alive = _rays(golden, 0)
    o3, d3 = tuple(o.unbind(1)), tuple(d.unbind(1))
    t_min = ct._f32(0.001)
    big = torch.full_like(tm, ct.BIG)
    dense = ct._closest_sphere(bake.sphere_table, o3, d3, tm, t_min, big)
    start = bake.sph_start[:, 0]
    leaves = np.nonzero(start >= 0)[0]
    wins = [int(((dense.row >= start[m]) & (dense.row < start[m] + ct.
                 SPH_LEAF_K) & dense.better & alive).sum()) for m in leaves]
    leaf = int(leaves[int(np.argmax(wins))])
    assert max(wins) > 20
    nodes, hit_nodes = bake.sph_nodes.copy(), bake.sph_hit_nodes.copy()
    nodes[leaf, :6] = hit_nodes[leaf, :6] = 1e4  # a point no ray reaches
    moved = bake._replace(sph_nodes=nodes, sph_hit_nodes=hit_nodes)
    walk = ct.sphere_walk_reference(moved, o3, d3, tm, t_min, big, alive,
                                    octant=True)
    got = ct.hit_reference(moved, o, d, tm, alive)
    lost = (alive & dense.better & (dense.row >= int(start[leaf]))
            & (dense.row < int(start[leaf]) + ct.SPH_LEAF_K))
    assert int(lost.sum()) == max(wins)
    hit = ((got.packed >> 16) & 1).bool()
    assert torch.equal(hit, walk.better)
    p = torch.stack([a + walk.t * b for a, b in zip(o3, d3)], dim=-1)
    assert torch.equal(got.p[hit], p[hit])
    mat = torch.as_tensor(bake.sphere_table[:, ct.SPHERE_SH + ct.SH_MAT])
    assert torch.equal((got.packed & 0xFFFF)[hit],
                       mat[walk.row][hit].to(torch.int32))
    # the dense loop's winner is gone from every lane that had it
    assert not (walk.row[lost & walk.better] == dense.row[lost
                                                          & walk.better]
                ).any()
    # on the true bake the walk keeps every dense winner
    same = ct.hit_reference(bake, o, d, tm, alive)
    assert torch.equal(((same.packed >> 16) & 1).bool(), dense.better & alive)
