"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips when no CUDA device is available.  This file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: depth 1 allclose(rtol=1e-5, atol=1e-5); depth 8, >= 99% of
lanes within atol 1e-3 * max and channel means within 1e-3 relative
(cosf/sinf may differ by a few ulp between the kernel and torch).  At every
depth, also >= 99.9% of the values bit-exact: the parity build
(-fmad=false, no fast math) has matched bit for bit on an H100, so a change
that rounds differently must lower that floor on purpose.  The RNG and the
launch count are exact.

Record planes: the bit rule (bits 16-18 equal everywhere, bits 0-15 where
bit 16 is set) and >= 99.9% of the words bit-exact against the plain
version; against the JAX golden every lane at bounce 0 and >= 99% of lanes
over all bounces (CUDA's and XLA's sin/cos differ by an ulp on some
draws).  The fused chunk: primal under the depth-8 rule, gradients allclose
rtol 2e-4, atol 1e-7 (tests/test_fused_diff.py).

The dense scenes: the same rules against the plain version; against
their JAX goldens >= 99% of pixels within atol 1e-3 * max and channel
means within 3e-3 relative (CUDA's and XLA's transcendentals differ by an
ulp here and there, and one diverging path moves a mean of these small
chunks on its own: at most 2.52e-3 over 16 keys per scene,
`tools/golden_spread.py`).  The FMA chain: rtol 1e-5 against its plain
version (one rounding a step against two).

Triangles: the hit kernel's tier and the megakernel's triangle walk under
the same rules against their plain versions; against the Pallas hit golden
the packed words equal on every lane and a triangle winner's id equal
except across a shared edge (`tests/test_torch_tri_hit.py`).

The record kernel's hit-point planes and BVH walks, and both ray-plane
entries: the bit rule and >= 99.9% of the words and of the hit-point
values bit-exact against their plain versions; against the Pallas goldens
the rules of tests/test_torch_record_p.py and tests/test_torch_rayplane.py
(bounce 0 on the lanes whose lens angle rounds as XLA's, hit points under
`cuda_trace.p_agreement`, radiance channel means within 3e-3).

The megakernel route's chunk launch (`Tracer.bind_chunk`): equal bit for
bit on every row to its (sample, wave) launches added in order and to
`trace_chunk_reference`, with one chunk launch and no per-wave launch.
The record chunk launch (`Tracer.bind_record_chunk`): every plane equal
bit for bit on every wave and lane to its per-wave launches stacked and to
`walk_chunk_reference`, for each record instantiation a scene or probe
uses and under a split into groups; the training routes' launch counts.

The record kernel's uv planes (image textures): the same bit rule and
>= 99.9% of the u and v values bit-exact against the plain version, on
camera rays and on ray planes; against the Pallas goldens the rules of
tests/test_torch_record_uv.py (`cuda_trace.uv_agreement`).

Sharding (`parallel/`): the fused chunk on a 1x1 mesh equals the unsharded
chunk bit for bit in the same launches; `dryrun_multichip` on two ranks
that share the card holds the sharded training step and wavefront to the
single-process ones.
"""

import gc
import os

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu_torch import (Camera, RenderSettings, SceneBuilder,
                                     compile_renderer)
from raytracing_gpu_tpu_torch.engine import diff, fused_diff
from raytracing_gpu_tpu_torch.models import scenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct
from raytracing_gpu_tpu_torch.utils import roofline

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
GOLDEN = os.path.join(DATA, "cornell_32.npz")
GRAD_GOLDEN = os.path.join(DATA, "cornell_grad_32.npz")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


EXACT_FLOOR = 0.999


DENSE_SCENES = ("basic", "first", "two_spheres", "two_perlin_spheres",
                "cornell_smoke")


def assert_matches(got, want, depth, exact_floor=EXACT_FLOOR, mean_rtol=1e-3):
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape and torch.isfinite(got).all()
    exact = float((got == want).double().mean())
    assert exact >= exact_floor, exact
    if depth <= 1:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    err = (got - want).abs()
    within = float((err <= 1e-3 * want.abs().max()).all(-1).double().mean())
    assert within >= 0.99, within
    torch.testing.assert_close(got.mean(0), want.mean(0), rtol=mean_rtol,
                               atol=0)


@pytest.mark.parametrize("salt", [0, 1, 7])
def test_rng_kernel_is_bit_exact(dev, salt):
    seed = int(np.random.default_rng(51).integers(-2**31, 2**31 - 1))
    got = ct.pcg_uniform(seed, 1 << 16, salt, dev)
    want = ct.pcg_uniform(seed, 1 << 16, salt, "cpu")
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("depth", [1, 8])
def test_kernel_matches_plain(dev, depth):
    sd = scenes.get("cornell_box")
    tracer = ct.Tracer(sd.scene, dev)
    seed = int(np.random.default_rng(52).integers(-2**31, 2**31 - 1))
    before = ct.Tracer.launches
    got = tracer.trace_pixels(sd.camera, 64, 64, 0, 4096, seed,
                              max_depth=depth)
    assert ct.Tracer.launches == before + 1
    want = ct.trace_pixels_reference(tracer.bake, sd.camera, 64, 64, 0, 4096,
                                     seed, max_depth=depth, device=dev)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert_matches(got, want, depth)


def test_kernel_matches_jax_golden(dev):
    g = np.load(GOLDEN)
    st = RenderSettings(image_width=int(g["image_width"]), aspect_ratio=1.0,
                        spp_per_chunk=int(g["spp_per_chunk"]), num_chunks=1,
                        max_depth=int(g["max_depth"]),
                        ray_batch=int(g["ray_batch"]), t_min=float(g["t_min"]))
    sd = scenes.get("cornell_box")
    before = (ct.Tracer.launches, ct.Tracer.chunk_launches)
    got = compile_renderer(sd.scene, sd.camera, st, dev)(int(g["base"]))
    # one launch for the chunk, none a wave
    assert (ct.Tracer.launches, ct.Tracer.chunk_launches) == \
        (before[0], before[1] + 1)
    assert_matches(got, torch.from_numpy(g["sums"]), st.max_depth)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    sd = scenes.get("cornell_box")
    tracer = ct.Tracer(sd.scene, dev)
    with pytest.raises(ValueError):
        tracer.trace_pixels(sd.camera, 64, 64, 0, 0, 1)
    tracer.rect_table = tracer.rect_table.double()
    with pytest.raises(ValueError, match="float32"):
        tracer.trace_pixels(sd.camera, 64, 64, 0, 128, 1)


@pytest.mark.parametrize("depth", [1, 8])
def test_record_kernel_matches_plain(dev, depth):
    sd = scenes.get("cornell_box")
    tracer = ct.Tracer(sd.scene, dev)
    seed = int(np.random.default_rng(53).integers(-2**31, 2**31 - 1))
    before = ct.Tracer.record_launches
    got = tracer.walk_packed_pixels(sd.camera, 64, 64, 0, 4096, seed,
                                    max_depth=depth)[0]
    assert ct.Tracer.record_launches == before + 1
    want = ct.walk_packed_pixels_reference(tracer.bake, sd.camera, 64, 64, 0,
                                           4096, seed, max_depth=depth,
                                           device=dev)[0]
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.int32
    res = ct.record_agreement(got, want)
    assert res["bit_rule"] and res["exact_frac"] >= EXACT_FLOOR, res


def _golden_settings(g):
    return RenderSettings(image_width=int(g["image_width"]), aspect_ratio=1.0,
                          spp_per_chunk=int(g["spp_per_chunk"]), num_chunks=1,
                          max_depth=int(g["max_depth"]),
                          ray_batch=int(g["ray_batch"]),
                          t_min=float(g["t_min"]))


def test_record_kernel_matches_jax_golden(dev):
    g = np.load(GRAD_GOLDEN)
    st = _golden_settings(g)
    sd = scenes.get("cornell_box")
    tracer = ct.Tracer(sd.scene, dev)
    b, h, w = st.ray_batch, st.image_height, st.image_width
    got = torch.stack([
        tracer.walk_packed_pixels(sd.camera, h, w, bid * b, b,
                                  ct.wave_seed(int(g["base"]), s, bid),
                                  st.max_depth, st.t_min)[0]
        for s in range(st.spp_per_chunk) for bid in range(h * w // b)])
    res = ct.record_agreement(got, g["planes"])
    assert res["first_bounce"] and res["lane_frac"] >= 0.99, res


# chunk launches: the primal, the forward of value_and_grad and, without
# saved planes, its backward's walk
@pytest.mark.parametrize("save_planes,walks", [(True, 2), (False, 3)])
def test_fused_chunk_matches_jax_golden(dev, save_planes, walks):
    g = np.load(GRAD_GOLDEN)
    st = _golden_settings(g)
    sd = scenes.get("cornell_box")
    chunk = fused_diff.compile_fused_param_renderer(
        sd.scene, sd.camera, st, save_planes=save_planes, device=dev)
    params = diff.get_params(sd.scene, dev)
    base = int(g["base"])
    before = (ct.Tracer.record_launches, ct.Tracer.record_chunk_launches)
    out = chunk(params, base)
    _, grads = diff.value_and_grad(params, lambda p: chunk(p, base),
                                   torch.full_like(out, float(g["target"])))
    assert (ct.Tracer.record_launches, ct.Tracer.record_chunk_launches) == \
        (before[0], before[1] + walks)
    assert_matches(out.detach(), torch.from_numpy(g["primal"]), st.max_depth)
    for k in diff.PARAM_KEYS:
        torch.testing.assert_close(grads[k].cpu(),
                                   torch.from_numpy(g[f"grad_{k}"]),
                                   rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("depth", [1, 8])
@pytest.mark.parametrize("name", DENSE_SCENES)
def test_dense_scene_kernel_matches_plain(dev, name, depth):
    sd = scenes.get(name)
    tracer = ct.Tracer(sd.scene, dev)
    seed = int(np.random.default_rng(54).integers(-2**31, 2**31 - 1))
    got = tracer.trace_pixels(sd.camera, 64, 64, 0, 4096, seed,
                              max_depth=depth)
    want = ct.trace_pixels_reference(tracer.bake, sd.camera, 64, 64, 0, 4096,
                                     seed, max_depth=depth, device=dev)
    torch.cuda.synchronize()
    assert_matches(got, want, depth)


@pytest.mark.parametrize("name", DENSE_SCENES)
def test_dense_scene_kernel_matches_jax_golden(dev, name):
    g = np.load(os.path.join(DATA, f"{name}_32.npz"))
    st = _golden_settings(g).with_(aspect_ratio=float(g["aspect_ratio"]))
    sd = scenes.get(name)
    got = compile_renderer(sd.scene, sd.camera, st, dev)(int(g["base"]))
    assert_matches(got, torch.from_numpy(g["sums"]), st.max_depth,
                   exact_floor=0.0, mean_rtol=3e-3)


@pytest.mark.parametrize("name", ["first", "cornell_smoke"])
def test_dense_record_kernel_matches_plain_and_golden(dev, name):
    sd = scenes.get(name)
    tracer = ct.Tracer(sd.scene, dev)
    got = tracer.walk_packed_pixels(sd.camera, 64, 64, 0, 4096, 77,
                                    max_depth=8)[0]
    want = ct.walk_packed_pixels_reference(tracer.bake, sd.camera, 64, 64, 0,
                                           4096, 77, max_depth=8,
                                           device=dev)[0]
    res = ct.record_agreement(got, want)
    assert res["bit_rule"] and res["exact_frac"] >= EXACT_FLOOR, res
    g = np.load(os.path.join(DATA, f"{name}_32.npz"))
    st = _golden_settings(g).with_(aspect_ratio=float(g["aspect_ratio"]))
    b, h, w = int(g["record_ray_batch"]), st.image_height, st.image_width
    got = torch.stack([
        tracer.walk_packed_pixels(sd.camera, h, w, bid * b, b,
                                  ct.wave_seed(int(g["base"]), s, bid),
                                  st.max_depth, st.t_min)[0]
        for s in range(st.spp_per_chunk) for bid in range(-(-h * w // b))])
    res = ct.record_agreement(got, g["planes"])
    assert res["first_bounce"] and res["lane_frac"] >= 0.99, res


def test_russian_roulette_kernel_matches_plain(dev):
    sd = scenes.get("cornell_smoke")
    tracer = ct.Tracer(sd.scene, dev)
    got = tracer.trace_pixels(sd.camera, 64, 64, 0, 4096, 31, max_depth=16,
                              rr_start=2)
    want = ct.trace_pixels_reference(tracer.bake, sd.camera, 64, 64, 0, 4096,
                                     31, 16, device=dev, rr_start=2)
    assert_matches(got, want, 16)


def test_features_no_registered_scene_uses(dev):
    # sphere medium, moving sphere, metal box, noise texture, a lens
    b = SceneBuilder()
    b.sphere_medium((0, 1, 0), 1.0, 0.3, (0.8, 0.6, 0.4))
    b.moving_sphere((2, 1, 0), (2, 1.5, 0), 0.0, 1.0, 0.5,
                    b.lambertian(b.noise(3.0)))
    b.box((-3, 0, -1), (-2, 1, 1), b.metal((0.9, 0.9, 0.9), 0.3),
          rotate_y=20.0)
    b.sphere((0, -100, 0), 100.0, b.lambertian(b.checker((0, 0, 0),
                                                         (1, 1, 1))))
    cam = Camera.make((0, 2, -8), (0, 1, 0), (0, 1, 0), 40.0, 1.0, 0.1, 8.0,
                      0.0, 1.0)
    tracer = ct.Tracer(b.build(), dev)
    for depth in (1, 8):
        got = tracer.trace_pixels(cam, 64, 64, 0, 4096, 5, max_depth=depth)
        want = ct.trace_pixels_reference(tracer.bake, cam, 64, 64, 0, 4096, 5,
                                         depth, device=dev)
        assert_matches(got, want, depth)


def test_bound_launch_keeps_its_tables(dev):
    sd = scenes.get("cornell_box")
    launch = ct.Tracer(sd.scene, dev).bind(sd.camera, 32, 32, 3)
    gc.collect()
    junk = [torch.zeros(1 << 16, device=dev) for _ in range(64)]
    got = launch(0, 1024, 9)
    want = ct.trace_pixels_reference(ct.bake_scene(sd.scene), sd.camera, 32,
                                     32, 0, 1024, 9, 3, device=dev)
    assert torch.equal(got, want) and float(got.sum()) > 0.0
    del junk


def test_fma_chain_kernel_matches_plain_and_ceilings(dev):
    x = torch.rand(1 << 20, generator=torch.Generator().manual_seed(8)).to(dev)
    before = roofline.launches
    # 1-21 steps: the chain has not converged, so a chain one step short
    # (the unrolled-by-8 loop or its tail miscounted) fails rtol 1e-5
    for k in (1, 7, 8, 13, 21, 300):
        want = roofline.fma_chain_reference(x, k)
        torch.testing.assert_close(roofline.fma_chain(x, k), want, rtol=1e-5,
                                   atol=0)
        if k < 300:
            assert not torch.allclose(roofline.fma_chain_reference(x, k - 1),
                                      want, rtol=1e-5, atol=0)
    assert roofline.launches == before + 6
    fma = roofline.fma_ceiling(dev)["flops_per_s"]
    peaks = roofline.card_peaks(dev)
    assert 1e12 < fma < 1.05 * peaks["flops_per_s"]
    assert 1e11 < roofline.hbm_ceiling(dev)["bytes_per_s"] < \
        1.05 * peaks["bytes_per_s"]


def test_kernel_times_sees_every_hand_kernel_launch(dev):
    # the profiler's account of a few launches of kernel 1a's wave entry,
    # each with its kernel time, as tools/roofline_torch.py reads it
    from raytracing_gpu_tpu_torch.utils.profiling import kernel_times

    sd = scenes.get("cornell_box")
    launch = ct.Tracer(sd.scene, dev).bind(sd.camera, 64, 64, 8)
    before = ct.Tracer.launches
    times = kernel_times(lambda: [launch(0, 4096, 9 + i) for i in range(5)])
    assert ct.Tracer.launches == before + 5
    hand = [v for k, v in times.items() if "megakernel_fwd" in k]
    assert sum(n for _, n in hand) == 5 and sum(t for t, _ in hand) > 0.0


# ---------------------------------------------------------------------------
# the sphere BVH and the pure closest-hit kernel (big_scene1)
# ---------------------------------------------------------------------------


def _camera_rays(sd, n, seed):
    """n camera rays of a scene on the CPU, 10% of the lanes dead."""
    gen = torch.Generator().manual_seed(seed)
    s, t = torch.rand(n, generator=gen), torch.rand(n, generator=gen)
    o, d, tm = sd.camera.get_rays(gen, s, t)
    alive = torch.rand(n, generator=gen) >= 0.1
    return o.contiguous(), d.contiguous(), tm.contiguous(), alive


def _one_bounce(sd, bake, rays, seed):
    """The rays scattered from the plain hit of `rays`, on the CPU."""
    from raytracing_gpu_tpu_torch.engine import wavefront
    from raytracing_gpu_tpu_torch.scene import materials

    o, d, tm, alive = rays
    hr = ct.hit_reference(bake, o, d, tm, alive)
    rec = wavefront.resolve_hit_packed(
        wavefront.pack_attr_table(sd.scene, bake.tri_perm), *hr, d)
    sc = materials.scatter(sd.scene, diff.get_params(sd.scene, "cpu"),
                           torch.Generator().manual_seed(seed), d, rec.p,
                           rec.normal, rec.front_face, rec.u, rec.v,
                           rec.mat_id)
    alive = alive & rec.hit & sc.ok
    return (torch.where(alive[:, None], rec.p, o).contiguous(),
            torch.where(alive[:, None], sc.direction, d).contiguous(), tm,
            alive)


@pytest.mark.parametrize("name", ["big_scene1", "first", "cornell_box"])
def test_hit_kernel_matches_plain(dev, name):
    sd = scenes.get(name)
    tracer = ct.Tracer(sd.scene, dev)
    rays = _camera_rays(sd, 65536, 61)
    for bounce in range(2):
        before = ct.Tracer.hit_launches
        got = tracer.hit(*(x.to(dev) for x in rays))
        assert ct.Tracer.hit_launches == before + 1
        want = ct.hit_reference(tracer.bake, *(x.to(dev) for x in rays))
        torch.cuda.synchronize()
        res = ct.hit_agreement(got, want)
        assert res["packed_equal"] and res["exact_frac"] >= EXACT_FLOOR, res
        assert res["hits"] > 10000, res
        rays = _one_bounce(sd, ct.bake_scene(sd.scene), rays, 62)


def test_hit_kernel_matches_pallas_golden(dev):
    g = np.load(os.path.join(DATA, "big_scene1_hit.npz"))
    tracer = ct.Tracer(scenes.get("big_scene1").scene, dev)
    for b in range(2):
        got = tracer.hit(*(torch.from_numpy(np.array(g[f"{k}{b}"])).to(dev)
                           for k in ("o", "d", "tm", "alive")))
        res = ct.hit_agreement(got, [g[f"{k}{b}"] for k in (
            "packed", "p", "u", "v", "normal")])
        assert res["packed_equal"] and res["within_limits"], res
        assert res["frac_close"] >= 0.99, res


def test_hit_wrapper_rejects_what_the_kernel_does_not_take(dev):
    tracer = ct.Tracer(scenes.get("big_scene1").scene, dev)
    o, d, tm, alive = _camera_rays(scenes.get("big_scene1"), 64, 3)
    with pytest.raises(ValueError, match="must be a contiguous"):
        tracer.hit(o, d, tm, alive)  # CPU tensors for a CUDA tracer
    with pytest.raises(ValueError, match="no media"):
        ct.Tracer(scenes.get("cornell_smoke").scene, dev).bind_hit()


@pytest.mark.parametrize("depth", [1, 8])
def test_sphere_bvh_kernel_matches_plain(dev, depth):
    sd = scenes.get("big_scene1")
    tracer = ct.Tracer(sd.scene, dev)
    assert tracer.bake.features() & ct.FEAT_SPHERE_BVH
    before = ct.Tracer.launches
    got = tracer.trace_pixels(sd.camera, 64, 64, 0, 4096, 91,
                              max_depth=depth)
    assert ct.Tracer.launches == before + 1
    want = ct.trace_pixels_reference(tracer.bake, sd.camera, 64, 64, 0, 4096,
                                     91, max_depth=depth, device=dev)
    torch.cuda.synchronize()
    assert_matches(got, want, depth)


def test_sphere_bvh_kernel_matches_jax_golden(dev):
    g = np.load(os.path.join(DATA, "big_scene1_32.npz"))
    st = _golden_settings(g).with_(aspect_ratio=float(g["aspect_ratio"]))
    sd = scenes.get("big_scene1")
    chunk = compile_renderer(sd.scene, sd.camera, st, dev)
    assert chunk.engine_name == "megakernel"
    assert_matches(chunk(int(g["base"])), torch.from_numpy(g["sums"]),
                   st.max_depth, exact_floor=0.0, mean_rtol=3e-3)


def test_regen_route_on_the_card_matches_jax_golden(dev):
    """The regen chunk at the pinned golden's settings, statistically: per
    channel the mean per-pixel difference within 4 standard errors."""
    g = np.load(os.path.join(DATA, "big_scene1_regen.npz"))
    st = _golden_settings(g).with_(aspect_ratio=float(g["aspect_ratio"]))
    sd = scenes.get("big_scene1")
    chunk = compile_renderer(sd.scene, sd.camera, st, dev)
    assert chunk.engine_name == "regen"
    fwd = ct.Tracer.launches + ct.Tracer.chunk_launches
    hits = ct.Tracer.hit_launches
    got = chunk(20241)
    steps = ct.Tracer.hit_launches - hits
    assert ct.Tracer.launches + ct.Tracer.chunk_launches == fwd
    assert 0.9 < steps / int(g["iterations"]) < 1.1
    npix = st.num_pixels
    diff_ = (got.cpu().double()[:npix] - torch.from_numpy(
        g["sums"][:npix]).double()) / st.spp_per_chunk
    z = diff_.mean(0) / (diff_.std(0) / npix ** 0.5)
    assert bool((z.abs() < 4.0).all()), z


# ---------------------------------------------------------------------------
# triangles: the hit kernel's tier and the megakernel's triangle walk
# ---------------------------------------------------------------------------


def _mesh(name):
    return (scenes.backpack_standin((16, 16)) if name == "mesh"
            else scenes.get(name))


@pytest.mark.parametrize("name,n", [("mesh", 65536), ("backpack", 8192)])
def test_tri_hit_kernel_matches_plain(dev, name, n):
    sd = _mesh(name)
    tracer = ct.Tracer(sd.scene, dev)
    rays = _camera_rays(sd, n, 63)
    for bounce in range(2):
        before = ct.Tracer.hit_launches
        got = tracer.hit(*(x.to(dev) for x in rays))
        assert ct.Tracer.hit_launches == before + 1
        want = ct.hit_reference(tracer.bake, *(x.to(dev) for x in rays))
        torch.cuda.synchronize()
        res = ct.hit_agreement(got, want)
        assert res["packed_equal"] and res["exact_frac"] >= EXACT_FLOOR, res
        assert torch.equal(got.slot, want.slot)
        tri = ((got.packed >> 20) & 1).bool()
        assert int(tri.sum()) > (n // 10 if bounce == 0 else 0)
        rays = _one_bounce(sd, tracer.bake, rays, 64)


def test_tri_hit_kernel_matches_pallas_golden(dev):
    g = np.load(os.path.join(DATA, "mesh_hit.npz"))
    tracer = ct.Tracer(_mesh("mesh").scene, dev)
    perm = g["perm"]
    assert np.array_equal(tracer.bake.tri_perm, perm)
    for b in range(2):
        got = tracer.hit(*(torch.from_numpy(np.array(g[f"{k}{b}"])).to(dev)
                           for k in ("o", "d", "tm", "alive")))
        res = ct.hit_agreement(got, [g[f"{k}{b}"] for k in (
            "packed", "p", "u", "v", "normal")])
        assert res["packed_equal"] and res["within_limits"], res
        assert res["frac_close"] >= 0.99, res
        tri = ((g[f"packed{b}"] >> 20) & 1).astype(bool)
        ids = perm[got.slot.cpu().numpy().astype(np.int64)[tri]]
        other = ids != perm[g[f"slot{b}"].astype(np.int64)[tri]]
        assert other.mean() <= 0.01, other.mean()


@pytest.mark.parametrize("name,depth", [("triangles", 1), ("triangles", 8),
                                        ("mesh", 8)])
def test_tri_bvh_kernel_matches_plain(dev, name, depth):
    sd = _mesh(name)
    tracer = ct.Tracer(sd.scene, dev)
    assert tracer.bake.features() & ct.FEAT_TRI_BVH
    before = ct.Tracer.launches
    got = tracer.trace_pixels(sd.camera, 64, 64, 0, 4096, 93,
                              max_depth=depth)
    assert ct.Tracer.launches == before + 1
    want = ct.trace_pixels_reference(tracer.bake, sd.camera, 64, 64, 0, 4096,
                                     93, max_depth=depth, device=dev)
    torch.cuda.synchronize()
    assert_matches(got, want, depth)


def test_tri_bvh_kernel_matches_jax_golden(dev):
    g = np.load(os.path.join(DATA, "triangles_32.npz"))
    st = _golden_settings(g).with_(aspect_ratio=float(g["aspect_ratio"]))
    sd = scenes.get("triangles")
    chunk = compile_renderer(sd.scene, sd.camera, st, dev)
    assert chunk.engine_name == "megakernel"
    assert_matches(chunk(int(g["base"])), torch.from_numpy(g["sums"]),
                   st.max_depth, exact_floor=0.0, mean_rtol=3e-3)


@pytest.mark.parametrize("engine", ["regen", "wavefront"])
def test_mesh_wavefronts_on_the_card_match_jax_golden(dev, engine):
    """Both wavefront drivers on the small mesh at the pinned JAX regen
    chunk's settings, statistically (z < 4 per channel)."""
    from raytracing_gpu_tpu_torch.engine import wavefront

    g = np.load(os.path.join(DATA, "mesh_regen.npz"))
    st = _golden_settings(g).with_(aspect_ratio=float(g["aspect_ratio"]))
    sd = _mesh("mesh")
    compile_wave = (wavefront.compile_regen_renderer if engine == "regen"
                    else wavefront.compile_wavefront_renderer)
    fwd = ct.Tracer.launches + ct.Tracer.chunk_launches
    hits = ct.Tracer.hit_launches
    got = compile_wave(sd.scene, sd.camera, st, device=dev)(20241)
    assert ct.Tracer.launches + ct.Tracer.chunk_launches == fwd
    assert ct.Tracer.hit_launches > hits
    npix = st.num_pixels
    diff_ = (got.cpu().double()[:npix] - torch.from_numpy(
        g["sums"][:npix]).double()) / st.spp_per_chunk
    z = diff_.mean(0) / (diff_.std(0) / npix ** 0.5)
    assert bool((z.abs() < 4.0).all()), z


# ---------------------------------------------------------------------------
# kernel 1b's hit-point planes and BVH walks, kernel 1c's ray planes
# ---------------------------------------------------------------------------

REC_SCENES = ("two_spheres", "two_perlin_spheres", "big_scene1", "triangles",
              "mesh")


def assert_record_matches(got, want):
    """Record planes of the kernel against its plain version's: the bit
    rule with >= 99.9% of the words equal, and the hit points bit-exact on
    >= 99.9% of the values."""
    assert len(got) == len(want)
    res = ct.record_agreement(got[0], want[0])
    assert res["bit_rule"] and res["exact_frac"] >= EXACT_FLOOR, res
    for a, b in zip(got[1:], want[1:]):
        exact = float((a.cpu() == b.cpu()).double().mean())
        assert exact >= EXACT_FLOOR, exact


@pytest.mark.parametrize("name", REC_SCENES)
def test_record_p_kernel_matches_plain(dev, name):
    sd = _mesh(name)
    tracer = ct.Tracer(sd.scene, dev)
    before = ct.Tracer.record_launches
    got = tracer.walk_packed_pixels(sd.camera, 64, 64, 0, 4096, 97,
                                    max_depth=8)
    assert ct.Tracer.record_launches == before + 1
    want = ct.walk_packed_pixels_reference(tracer.bake, sd.camera, 64, 64, 0,
                                           4096, 97, max_depth=8, device=dev)
    torch.cuda.synchronize()
    assert len(got) == (4 if tracer.need_p else 1)
    assert_record_matches(got, want)


@pytest.mark.parametrize("name", REC_SCENES[:4])
def test_record_p_kernel_matches_pallas_golden(dev, name):
    g = np.load(os.path.join(DATA, f"{name}_rec32.npz"))
    st = _golden_settings(g).with_(aspect_ratio=float(g["aspect_ratio"]))
    sd = scenes.get(name)
    tracer = ct.Tracer(sd.scene, dev)
    h, w, b = st.image_height, st.image_width, st.ray_batch
    waves = [(bid * b, b, ct.wave_seed(int(g["base"]), s, bid))
             for s in range(st.spp_per_chunk) for bid in range(-(-h * w // b))]
    planes = [tracer.walk_packed_pixels(sd.camera, h, w, *wv, st.max_depth,
                                        st.t_min) for wv in waves]
    got = torch.stack([p[0] for p in planes])
    same = None
    if "lens_cs" in g:
        same = np.stack([(ct.lens_cos_sin(seed, n, dev).cpu().numpy()
                          == g["lens_cs"][i]).all(0)
                         for i, (_, n, seed) in enumerate(waves)])
    agree = ct.record_agreement(got, g["planes"], same)
    assert agree["first_bounce"] and agree["lane_frac"] >= 0.99, agree
    if tracer.need_p:
        res = ct.p_agreement(got, g["planes"], torch.stack(
            [torch.stack(p[1:]) for p in planes]), g["p"])
        assert res["hit_rule"], res


@pytest.mark.parametrize("name", ["cornell_box", "big_scene1", "mesh"])
def test_ray_plane_kernels_match_plain(dev, name):
    sd = _mesh(name)
    tracer = ct.Tracer(sd.scene, dev)
    o, d, tm, _ = (x.to(dev) for x in _camera_rays(sd, 4096, 98))
    before = ct.Tracer.ray_launches
    got = tracer.walk_packed(o, d, tm, 99, max_depth=8)
    want = ct.walk_packed_reference(tracer.bake, o, d, tm, 99, 8)
    assert_record_matches(got, want)
    for rr in (0, 2):
        got = tracer(o, d, tm, 99, max_depth=8, rr_start=rr)
        want = ct.trace_rays_reference(tracer.bake, o, d, tm, 99, 8,
                                       rr_start=rr)
        torch.cuda.synchronize()
        assert_matches(got, want, 8)
    assert ct.Tracer.ray_launches == before + 3


@pytest.mark.parametrize("name", ["cornell_box", "big_scene1"])
def test_ray_plane_kernels_match_pallas_golden(dev, name):
    g = np.load(os.path.join(DATA, f"{name}_rays.npz"))
    tracer = ct.Tracer(scenes.get(name).scene, dev)
    rays = [torch.from_numpy(np.ascontiguousarray(g[k])).to(dev)
            for k in ("o", "d", "tm")]
    depth, seed = int(g["max_depth"]), int(g["seed"])
    planes = tracer.walk_packed(*rays, seed, max_depth=depth)
    agree = ct.record_agreement(planes[0], g["planes"])
    assert agree["first_bounce"] and agree["lane_frac"] >= 0.99, agree
    if tracer.need_p:
        res = ct.p_agreement(planes[0], g["planes"],
                             torch.stack(planes[1:]), g["p"])
        assert res["hit_rule"], res
    got = tracer(*rays, seed, max_depth=depth)
    assert_matches(got, torch.from_numpy(g["radiance"]), depth,
                   exact_floor=0.0, mean_rtol=3e-3)


def test_fused_chunk_with_p_matches_plain_walk(dev):
    sd = scenes.get("two_spheres")
    st = RenderSettings(image_width=64, aspect_ratio=sd.aspect,
                        spp_per_chunk=2, num_chunks=1, max_depth=8,
                        ray_batch=1024)
    tracer = ct.Tracer(sd.scene, dev)
    h, w = st.image_height, st.image_width
    params = diff.get_params(sd.scene, dev)

    def run(chunk):
        out = chunk(params, 555)
        _, grads = diff.value_and_grad(params, lambda p: chunk(p, 555),
                                       torch.full_like(out, 0.25))
        return out.detach(), grads

    out, grads = run(fused_diff.compile_fused_param_renderer(
        sd.scene, sd.camera, st, device=dev))
    ref, ref_grads = run(fused_diff.fused_chunk_from_walk(
        sd.scene, lambda pb, n, seed: ct.walk_packed_pixels_reference(
            tracer.bake, sd.camera, h, w, pb, n, seed, st.max_depth,
            st.t_min, dev), st, device=dev))
    assert_matches(out, ref, st.max_depth)
    for k in diff.PARAM_KEYS:
        torch.testing.assert_close(grads[k], ref_grads[k], rtol=2e-4,
                                   atol=1e-7)


def test_param_renderer_routes_launch_their_kernels(dev):
    from raytracing_gpu_tpu_torch.engine import render

    sd = scenes.get("big_scene1")
    st = RenderSettings(image_width=64, aspect_ratio=sd.aspect,
                        spp_per_chunk=2, num_chunks=1, max_depth=4,
                        ray_batch=1024)
    params = diff.get_params(sd.scene, dev)
    walk = render.compile_param_renderer(sd.scene, sd.camera, st, device=dev)
    fused = fused_diff.compile_fused_param_renderer(
        sd.scene, sd.camera, st, gen_rays=False, device=dev)
    assert walk.engine_name == "record-walk"
    counts = (ct.Tracer.launches, ct.Tracer.chunk_launches,
              ct.Tracer.record_launches, ct.Tracer.record_chunk_launches,
              ct.Tracer.hit_launches)
    before = ct.Tracer.ray_launches
    assert torch.equal(walk(params, 9), fused(params, 9))
    waves = st.spp_per_chunk * render._grid_geometry(st)[5]
    assert ct.Tracer.ray_launches == before + 2 * waves
    assert (ct.Tracer.launches, ct.Tracer.chunk_launches,
            ct.Tracer.record_launches, ct.Tracer.record_chunk_launches,
            ct.Tracer.hit_launches) == counts
    msd = _mesh("mesh")
    wave = render.compile_param_renderer(msd.scene, msd.camera,
                                         st.with_(aspect_ratio=msd.aspect),
                                         engine="wavefront", device=dev,
                                         debug_stats=True)
    hits = ct.Tracer.hit_launches
    out, stats = wave(diff.get_params(msd.scene, dev), 9)
    assert ct.Tracer.hit_launches - hits == stats["iterations"] > 0
    assert bool(torch.isfinite(out).all())


def test_tracer_takes_the_bare_cuda_device(dev):
    # "cuda" (the entry points' default) names the current card; the
    # wrappers compare it with the tensors' cuda:N
    sd = scenes.get("big_scene1")
    tracer = ct.Tracer(sd.scene, "cuda")
    assert tracer.device == dev
    assert tracer.trace_pixels(sd.camera, 16, 16, 0, 256, 3, 2).shape == \
        (256, 3)
    o, d, tm, alive = (x.to(dev) for x in _camera_rays(sd, 256, 4))
    assert tracer.hit(o, d, tm, alive).packed.shape == (256,)
    assert len(tracer.walk_packed(o, d, tm, 5, max_depth=2)) == 4


# ---------------------------------------------------------------------------
# kernel 1b's uv planes (image textures)
# ---------------------------------------------------------------------------

UV_SCENES = ("image_probe", "image_spheres", "image_mesh", "earth",
             "backpack_map")


def _image_scene(name):
    """(scene, camera) of an image-textured scene on a synthetic map."""
    from raytracing_gpu_tpu_torch.models import probes

    if name == "earth":
        sd = scenes.earth(probes.synthetic_image(512, 1024, 7))
    elif name == "backpack_map":
        sd = scenes.backpack_standin(texture=probes.synthetic_image(1024,
                                                                    1024, 9))
    else:
        scene, cam, _ = getattr(probes, name)(SceneBuilder, Camera)
        return scene, cam
    return sd.scene, sd.camera


@pytest.mark.parametrize("name", UV_SCENES)
def test_uv_record_kernel_matches_plain(dev, name):
    scene, cam = _image_scene(name)
    tracer = ct.Tracer(scene, dev)
    assert tracer.need_uv and not tracer.supports_forward
    n, pix = (8192, 3 * 65536) if name == "backpack_map" else (4096, 0)
    h, w = (600, 800) if name == "backpack_map" else (64, 64)
    got = tracer.walk_packed_pixels(cam, h, w, pix, n, 101, max_depth=8)
    want = ct.walk_packed_pixels_reference(tracer.bake, cam, h, w, pix, n,
                                           101, max_depth=8, device=dev)
    torch.cuda.synchronize()
    assert len(got) == 3
    assert_record_matches(got, want)
    assert int(((got[0] >> 16) & 1).sum()) > n // 4
    if name in ("earth", "image_probe"):  # kernel 1c with the uv planes
        o, d, tm, _ = (x.to(dev) for x in _camera_rays(
            scenes.SceneDef(scene, cam, 1.0), n, 102))
        assert_record_matches(tracer.walk_packed(o, d, tm, 103, max_depth=8),
                              ct.walk_packed_reference(tracer.bake, o, d, tm,
                                                       103, 8))


@pytest.mark.parametrize("name", ["image_probe_uv32", "image_spheres_uv32",
                                  "image_mesh_uv32", "earth_fused32"])
def test_uv_record_kernel_matches_pallas_golden(dev, name):
    from raytracing_gpu_tpu_torch.models import probes

    g = np.load(os.path.join(DATA, f"{name}.npz"))
    st = _golden_settings(g).with_(aspect_ratio=float(g["aspect_ratio"]))
    if name == "earth_fused32":
        sd = scenes.earth(probes.synthetic_image(*(int(x) for x in
                                                   g["earth_map"])))
        scene, cam = sd.scene, sd.camera
    else:
        scene, cam, _ = getattr(probes, name[:-5])(SceneBuilder, Camera)
    tracer = ct.Tracer(scene, dev)
    h, w, b = st.image_height, st.image_width, st.ray_batch
    waves = [(bid * b, b, ct.wave_seed(int(g["base"]), s, bid))
             for s in range(st.spp_per_chunk) for bid in range(-(-h * w // b))]
    planes = [tracer.walk_packed_pixels(cam, h, w, *wv, st.max_depth,
                                        st.t_min) for wv in waves]
    got = torch.stack([p[0] for p in planes])
    same = None
    if "lens_cs" in g:
        same = np.stack([(ct.lens_cos_sin(seed, n, dev).cpu().numpy()
                          == g["lens_cs"][i]).all(0)
                         for i, (_, n, seed) in enumerate(waves)])
    agree = ct.record_agreement(got, g["planes"], same)
    assert agree["first_bounce"] and agree["lane_frac"] >= 0.99, agree
    res = ct.uv_agreement(got, g["planes"], torch.stack(
        [torch.stack(p[1:]) for p in planes]), g["uv"], ct.UV_LIMIT0[name])
    assert res["rule"], res


def test_image_fused_chunk_matches_plain_walk(dev):
    scene, cam = _image_scene("image_probe")
    st = RenderSettings(image_width=64, aspect_ratio=1.0, spp_per_chunk=2,
                        num_chunks=1, max_depth=4, ray_batch=2048)
    tracer = ct.Tracer(scene, dev)
    params = diff.get_params(scene, dev)

    def value_and_grad(chunk):
        out = chunk(params, 5)
        _, grads = diff.value_and_grad(params, lambda p: chunk(p, 5),
                                       torch.zeros_like(out))
        return out.detach(), grads

    out, grads = value_and_grad(fused_diff.compile_fused_param_renderer(
        scene, cam, st, device=dev))
    ref, ref_grads = value_and_grad(fused_diff.fused_chunk_from_walk(
        scene, lambda pb, n, seed: ct.walk_packed_pixels_reference(
            tracer.bake, cam, 64, 64, pb, n, seed, 4, device=dev), st,
        device=dev))
    assert_matches(out, ref, 4)
    for k in diff.PARAM_KEYS:
        torch.testing.assert_close(grads[k], ref_grads[k], rtol=2e-4,
                                   atol=1e-7)
    split = int(scene.atlas.offset[1]) * 3
    g = grads["atlas_data"]
    assert bool((g[:split] != 0).any()) and bool((g[split:] != 0).any())


@pytest.mark.parametrize("name", ["earth", "image_spheres"])
def test_hit_kernel_on_image_scenes_matches_plain(dev, name):
    # the hit kernel shares sphere_uv with the record kernel
    scene, cam = _image_scene(name)
    tracer = ct.Tracer(scene, dev)
    rays = [x.to(dev) for x in _camera_rays(scenes.SceneDef(scene, cam, 1.0),
                                             65536, 104)]
    res = ct.hit_agreement(tracer.hit(*rays),
                           ct.hit_reference(tracer.bake, *rays))
    assert res["packed_equal"] and res["exact_frac"] >= EXACT_FLOOR, res


# ---------------------------------------------------------------------------
# the warp-cooperative BVH walks on every lane: a partial last warp, sparse
# live lanes, exact ties
# ---------------------------------------------------------------------------


def _every_lane_sd(name):
    if name == "tie":
        from raytracing_gpu_tpu_torch.models import probes

        scene, cam, aspect = probes.tie_mesh(SceneBuilder, Camera)
        return scenes.SceneDef(scene, cam, aspect)
    return _mesh(name)


def _lane_masks(n):
    """Half the lanes dead at random, every other warp dead, and every lane
    live but warp 1's, which keeps one."""
    lane = torch.arange(n)
    one = torch.ones(n, dtype=torch.bool)
    one[32:64] = False
    one[49] = True
    return [torch.rand(n, generator=torch.Generator().manual_seed(5)) >= 0.5,
            (lane // 32) % 2 == 0, one]


@pytest.mark.parametrize("name", ["big_scene1", "backpack", "tie"])
def test_hit_kernel_matches_plain_on_every_lane(dev, name):
    sd = _every_lane_sd(name)
    tracer = ct.Tracer(sd.scene, dev)
    rays = _camera_rays(sd, 65536 + 37, 65)
    for bounce in range(2):
        o, d, tm, alive = (x.to(dev) for x in rays)
        for mask in _lane_masks(len(tm)):
            live = (alive & mask.to(dev)).contiguous()
            got = tracer.hit(o, d, tm, live)
            want = ct.hit_reference(tracer.bake, o, d, tm, live)
            torch.cuda.synchronize()
            for k, g, w in zip(got._fields, got, want):
                assert torch.equal(g, w), (k, bounce)
        rays = _one_bounce(sd, tracer.bake, rays, 66)


@pytest.mark.parametrize("name,depth", [("big_scene1", 16), ("tie", 8),
                                        ("mesh", 8)])
def test_bvh_waves_match_plain_on_every_lane(dev, name, depth):
    sd = _every_lane_sd(name)
    tracer = ct.Tracer(sd.scene, dev)
    n, h, w, seed = 32768 + 37, 450, 800, 67
    got = tracer.walk_packed_pixels(sd.camera, h, w, 0, n, seed,
                                    max_depth=depth)
    want = ct.walk_packed_pixels_reference(tracer.bake, sd.camera, h, w, 0,
                                           n, seed, depth, device=dev)
    o, d, tm, _ = (x.to(dev) for x in _camera_rays(sd, n, 68))
    got_r = tracer.walk_packed(o, d, tm, seed, max_depth=depth)
    want_r = ct.walk_packed_reference(tracer.bake, o, d, tm, seed, depth)
    fwd = tracer.trace_pixels(sd.camera, h, w, 0, n, seed, max_depth=depth)
    fwd_want = ct.trace_pixels_reference(tracer.bake, sd.camera, h, w, 0, n,
                                         seed, depth, device=dev)
    torch.cuda.synchronize()
    for a, b in zip((*got, *got_r, fwd), (*want, *want_r, fwd_want)):
        assert torch.equal(a, b)
    assert len(got) == len(want) and len(got_r) == len(want_r)


# ---------------------------------------------------------------------------
# the chunk launch: one persistent launch a sample chunk
# ---------------------------------------------------------------------------

# scene, width, ray_batch, spp a chunk, depth, rr_start: Cornell at 512x512
# has more rows than the card holds threads (rows from the counter); `first`
# 50 wide pads its last wave; big_scene1 walks the sphere BVH by warps
CHUNK_CASES = [("cornell_box", 512, 65536, 2, 8, 0),
               ("first", 50, 768, 3, 8, 0),
               ("cornell_smoke", 64, 1024, 4, 16, 0),
               ("cornell_smoke", 64, 1024, 4, 16, 2),
               ("big_scene1", 80, 1024, 8, 16, 0),
               ("triangles", 64, 1024, 4, 8, 0),
               ("cornell_box", 48, 1024, 1, 8, 0)]


@pytest.mark.parametrize("name,width,batch,spp,depth,rr", CHUNK_CASES)
def test_chunk_launch_equals_waves_and_plain(dev, name, width, batch, spp,
                                             depth, rr):
    sd = scenes.get(name)
    st = RenderSettings(image_width=width, aspect_ratio=sd.aspect,
                        spp_per_chunk=spp, num_chunks=1, max_depth=depth,
                        ray_batch=batch, rr_start=rr)
    h, w = st.image_height, st.image_width
    base = int(np.random.default_rng(95).integers(0, 2**31 - 1))
    chunk = compile_renderer(sd.scene, sd.camera, st, dev)
    assert chunk.engine_name == "megakernel"
    before = (ct.Tracer.launches, ct.Tracer.chunk_launches)
    got = chunk(base)
    assert (ct.Tracer.launches, ct.Tracer.chunk_launches) == \
        (before[0], before[1] + 1)
    tracer = ct.Tracer(sd.scene, dev)
    b = min(batch, -(-h * w // 8) * 8)
    rows = ct.chunk_rows(h, w, b)
    assert got.shape == (rows, 3) and got.dtype == torch.float32
    # the per-wave kernel route, its sums added in order
    wave = tracer.bind(sd.camera, h, w, depth, st.t_min, rr)
    waves = torch.zeros((rows, 3), dtype=torch.float32, device=dev)
    for s in range(spp):
        for bid in range(rows // b):
            waves[bid * b:(bid + 1) * b] += wave(bid * b, b,
                                                 ct.wave_seed(base, s, bid))
    want = ct.trace_chunk_reference(tracer.bake, sd.camera, h, w, base, spp,
                                    b, depth, st.t_min, dev, rr)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and float(got.sum()) > 0.0
    assert torch.equal(got, waves)
    assert torch.equal(got, want)


def test_chunk_launch_fills_the_card(dev):
    sd = scenes.get("cornell_box")
    launch = ct.Tracer(sd.scene, dev).bind_chunk(sd.camera, 64, 64, 8, 0.001,
                                                 0, 1024, 2)
    per_sm, sms, grid = launch.occupancy
    props = torch.cuda.get_device_properties(dev)
    assert sms == props.multi_processor_count and grid == per_sm * sms
    assert per_sm * 128 <= props.max_threads_per_multi_processor
    assert per_sm >= 4  # more than a 65,536-ray wave's 512 blocks
    gc.collect()
    got = launch(7)
    assert torch.equal(got, ct.trace_chunk_reference(
        ct.bake_scene(sd.scene), sd.camera, 64, 64, 7, 2, 1024, 8,
        device=dev))


# ---------------------------------------------------------------------------
# the record chunk launch: a training chunk's walk in one persistent launch
# ---------------------------------------------------------------------------

def _record_sd(name):
    """(scene, camera, aspect) of a registered scene, the 16 x 16 mesh, the
    tie scene or an image probe."""
    from raytracing_gpu_tpu_torch.models import probes

    if name in ("image_probe", "image_spheres"):
        return getattr(probes, name)(SceneBuilder, Camera)
    sd = _every_lane_sd(name) if name in ("tie", "mesh") else scenes.get(name)
    return sd.scene, sd.camera, sd.aspect


# scene, width, ray_batch, spp, depth, budget in waves (0: one group); the
# record instantiations the scenes and probes use: Cornell (none: rects and
# boxes; its 512 x 512 chunk has more rays than the grid has threads),
# two_spheres (dense spheres, p), cornell_smoke (media), big_scene1 (the
# sphere BVH, p; split into groups of 3 waves), `triangles` and the tie
# scene (the triangle BVH; ray_batch 1,000 ends a wave inside a warp),
# the image probe (dense sphere, media, triangles, uv) and the image
# spheres (the sphere BVH, uv)
RECORD_CHUNK_CASES = [("cornell_box", 512, 32768, 2, 8, 0),
                      ("two_spheres", 64, 1024, 3, 8, 0),
                      ("cornell_smoke", 64, 1024, 4, 16, 0),
                      ("big_scene1", 80, 1024, 4, 16, 3),
                      ("triangles", 64, 1000, 3, 8, 0),
                      ("tie", 64, 1000, 2, 8, 2),
                      ("image_probe", 64, 1024, 2, 8, 0),
                      ("image_spheres", 80, 1024, 2, 16, 0)]


@pytest.mark.parametrize("name,width,batch,spp,depth,budget",
                         RECORD_CHUNK_CASES)
def test_record_chunk_launch_equals_waves_and_plain(dev, name, width, batch,
                                                    spp, depth, budget,
                                                    monkeypatch):
    scene, cam, aspect = _record_sd(name)
    h = int(width / aspect)
    tracer = ct.Tracer(scene, dev)
    entry = 4 * (1 + 3 * tracer.need_p + 2 * tracer.need_uv)
    if budget:
        monkeypatch.setattr(ct, "RECORD_CHUNK_BYTES",
                            budget * entry * depth * batch)
    launch = tracer.bind_record_chunk(cam, h, width, depth, 0.001, batch,
                                      spp)
    nb = launch.nb
    assert len(launch.groups) == (-(-spp * nb // budget) if budget else 1)
    base = int(np.random.default_rng(97).integers(0, 2**31 - 1))
    before = (ct.Tracer.record_launches, ct.Tracer.record_chunk_launches)
    groups = [launch(base, first, count) for first, count in launch.groups]
    assert (ct.Tracer.record_launches, ct.Tracer.record_chunk_launches) == \
        (before[0], before[1] + len(launch.groups))
    got = tuple(torch.cat(p) for p in zip(*groups))
    wave = tracer.bind_record(cam, h, width, depth)
    waves = [wave(bid * batch, batch, ct.wave_seed(base, s, bid))
             for s in range(spp) for bid in range(nb)]
    want = ct.walk_chunk_reference(tracer.bake, cam, h, width, base, spp,
                                   batch, depth, device=dev)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 1 + 3 * tracer.need_p + \
        2 * tracer.need_uv
    for k, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == (spp * nb, depth, batch)
        assert torch.equal(g, torch.stack([x[k] for x in waves])), k
        assert torch.equal(g, w), k
    assert int(((got[0] >> 16) & 1).sum()) > 0


def test_record_chunk_launch_fills_the_card(dev):
    sd = scenes.get("cornell_box")
    launch = ct.Tracer(sd.scene, dev).bind_record_chunk(
        sd.camera, 512, 512, 8, 0.001, 32768, 8)
    per_sm, sms, grid = launch.occupancy
    props = torch.cuda.get_device_properties(dev)
    assert sms == props.multi_processor_count and grid == per_sm * sms
    assert per_sm * 128 <= props.max_threads_per_multi_processor
    assert per_sm >= 4  # more than a 32,768-ray wave's 256 blocks
    assert launch.groups == [(0, 64)]
    gc.collect()
    got = launch(11)[0]
    assert torch.equal(got, ct.walk_chunk_reference(
        ct.bake_scene(sd.scene), sd.camera, 512, 512, 11, 8, 32768, 8,
        device=dev)[0])


@pytest.mark.parametrize("name", ["tie", "mesh"])
def test_tri_walk_chunks_match_plain_on_every_lane(dev, name):
    # the triangle walk in both chunk launches: waves of 1,000 rays end
    # inside warps, and paths end at every bounce, so warps walk with
    # partial and sparse live lanes
    scene, cam, aspect = _record_sd(name)
    tracer = ct.Tracer(scene, dev)
    st = RenderSettings(image_width=64, aspect_ratio=aspect, spp_per_chunk=3,
                        num_chunks=1, max_depth=8, ray_batch=1000)
    h, w = st.image_height, st.image_width
    fwd = tracer.bind_chunk(cam, h, w, 8, st.t_min, 0, 1000, 3)(5)
    rec = tracer.bind_record_chunk(cam, h, w, 8, st.t_min, 1000, 3)(5)
    want_fwd = ct.trace_chunk_reference(tracer.bake, cam, h, w, 5, 3, 1000,
                                        8, st.t_min, dev)
    want_rec = ct.walk_chunk_reference(tracer.bake, cam, h, w, 5, 3, 1000, 8,
                                       st.t_min, dev)
    torch.cuda.synchronize()
    assert torch.equal(fwd, want_fwd)
    for g, v in zip(rec, want_rec):
        assert torch.equal(g, v)
    hits = (rec[0] >> 16) & 1
    assert int(hits.sum()) > 0 and int((1 - hits[:, 1:]).sum()) > 0


def test_training_routes_make_one_record_launch_a_chunk(dev):
    # bench.py's Cornell render (8 chunks of 8 spp, waves of 32,768, planes
    # kept), big_scene1 in training as chip_smoke.py phase 30 runs it (2
    # chunks of 16 spp, depth 16, planes walked again backward) and
    # `triangles` in training (one chunk of 8 spp, planes kept)
    cases = [("cornell_box", RenderSettings(
                 image_width=512, aspect_ratio=1.0, spp_per_chunk=8,
                 num_chunks=8, max_depth=8, ray_batch=32768), 8),
             ("big_scene1", RenderSettings(
                 image_width=800, aspect_ratio=16 / 9, spp_per_chunk=16,
                 num_chunks=2, max_depth=16, ray_batch=32768), 4),
             ("triangles", RenderSettings(
                 image_width=400, aspect_ratio=16 / 9, spp_per_chunk=8,
                 num_chunks=1, max_depth=8, ray_batch=65536), 1)]
    for name, st, expected in cases:
        sd = scenes.get(name)
        chunk = fused_diff.compile_fused_param_renderer(sd.scene, sd.camera,
                                                        st, device=dev)
        params = diff.get_params(sd.scene, dev)
        gen = torch.Generator().manual_seed(1984)
        bases = [ct.chunk_seed(gen) for _ in range(st.num_chunks)]
        target = torch.zeros_like(chunk(params, bases[0]))
        torch.cuda.synchronize()
        before = (ct.Tracer.record_launches, ct.Tracer.record_chunk_launches,
                  ct.Tracer.launches, ct.Tracer.chunk_launches,
                  ct.Tracer.ray_launches, ct.Tracer.hit_launches)
        loss = 0.0
        for base in bases:  # bench_torch.train_renders' loop
            chunk_loss, grads = diff.value_and_grad(
                params, lambda p, base=base: chunk(p, base), target)
            loss = loss + chunk_loss
        torch.cuda.synchronize()
        after = (ct.Tracer.record_launches, ct.Tracer.record_chunk_launches,
                 ct.Tracer.launches, ct.Tracer.chunk_launches,
                 ct.Tracer.ray_launches, ct.Tracer.hit_launches)
        assert [a - b for a, b in zip(after, before)] == \
            [0, expected, 0, 0, 0, 0], name
        assert bool(torch.isfinite(loss)) and float(loss) > 0.0, name
        del chunk, target, grads
        gc.collect()


@pytest.mark.parametrize("gen_rays", [True, False])
def test_sharded_fused_on_a_1x1_mesh_is_the_chunk(dev, gen_rays):
    # without a process group the mesh is 1x1 and its collectives are the
    # identity: the sharded chunk walks the same waves in the same
    # launches (one record chunk launch, or one ray-plane launch a wave)
    from raytracing_gpu_tpu_torch.parallel.mesh import make_mesh

    sd = scenes.get("cornell_box")
    st = RenderSettings(image_width=64, aspect_ratio=1.0, spp_per_chunk=4,
                        num_chunks=1, max_depth=8, ray_batch=2048)
    params = diff.get_params(sd.scene, dev)
    runs = []
    for mesh in (None, make_mesh()):
        chunk = fused_diff.compile_fused_param_renderer(
            sd.scene, sd.camera, st, gen_rays=gen_rays, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        before = (ct.Tracer.record_chunk_launches, ct.Tracer.ray_launches)
        out = chunk(params, 77)
        loss, grads = diff.value_and_grad(params, lambda p: chunk(p, 77),
                                          torch.zeros_like(out))
        torch.cuda.synchronize()
        after = (ct.Tracer.record_chunk_launches, ct.Tracer.ray_launches)
        runs.append((out, grads, [a - b for a, b in zip(after, before)]))
    (a, ga, na), (b, gb, nb) = runs
    assert torch.equal(a, b) and na == nb and sum(na) > 0
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


def test_dryrun_multichip_on_two_ranks_of_the_card(dev):
    # two ranks that share the card take gloo (NCCL refuses them); the
    # training step and the door wavefront against the single-process ones
    from raytracing_gpu_tpu_torch.parallel import distributed, dryrun

    assert distributed.choose_backend("cuda", torch.cuda.device_count() + 1) \
        == "gloo"
    report = dryrun.dryrun_multichip(2, device="cuda", deadline=300.0)
    assert report["loss"] > 0.0 and report["grad_err"] <= 1e-4
