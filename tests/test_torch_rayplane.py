"""Kernel 1c on the CPU: the megakernel's ray-plane input, both modes.

The port's plain ray-plane versions (`walk_packed_reference`,
`trace_rays_reference`, which the CUDA kernel equals on the card) against
`PallasTracer.walk_packed` and `PallasTracer.__call__` in interpret mode,
pinned by `tools/make_torch_goldens.py` (`<scene>_rays.npz`: 512 camera rays
drawn by JAX, the key, and the int32 seed `_tile_args` draws from it; depth
8).  Both sides trace the same rays with the same seed; the Pallas kernel
pads the planes to whole (8, 128) tiles, and lane i's random numbers
depend only on i and the seed.

Rules: record planes under the bit rule, every lane at bounce 0 (the rays
are given) and >= 99% of lanes over all bounces; hit points under
`cuda_trace.p_agreement` (tests/test_torch_record_p.py); radiance under
the rule of the forward goldens (tests/test_torch_spheres.py): >= 99% of
rays within atol 1e-3 * max and every channel mean within 3e-3 relative
(XLA's and torch's sin, cos, log and exp differ by an ulp here and there,
and one path that diverges after a bounce moves a mean of 512 rays on its
own; `tools/golden_spread.py`).  Within the port, the ray-plane versions
fed the in-kernel camera's own rays equal the camera-ray versions bit for
bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu_torch.engine.integrator import unpack_walk
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import build
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
RAY_SCENES = ("cornell_box", "big_scene1")


@pytest.fixture(scope="module", params=RAY_SCENES)
def golden(request):
    name = request.param
    g = np.load(os.path.join(DATA, f"{name}_rays.npz"))
    rays = tuple(torch.from_numpy(np.ascontiguousarray(g[k]))
                 for k in ("o", "d", "tm"))
    return name, g, rays, ct.Tracer(tscenes.get(name).scene, "cpu")


def test_seed_is_the_tile_args_draw(golden):
    _, g, _, _ = golden
    key = jax.random.wrap_key_data(np.asarray(g["key"]))
    seed = jax.random.randint(key, (1,), 0, 2**31 - 1, np.int32)
    assert int(seed[0]) == int(g["seed"])


def test_walk_packed_matches_pallas_golden(golden):
    name, g, rays, tracer = golden
    planes = tracer.walk_packed(*rays, int(g["seed"]),
                                max_depth=int(g["max_depth"]),
                                t_min=float(g["t_min"]))
    assert tracer.need_p == bool(g["need_p"]) == (name == "big_scene1")
    assert len(planes) == (4 if tracer.need_p else 1)
    agree = ct.record_agreement(planes[0], g["planes"])
    assert agree["first_bounce"] and agree["lane_frac"] >= 0.99, agree
    if tracer.need_p:
        res = ct.p_agreement(planes[0], g["planes"], torch.stack(planes[1:]),
                             g["p"])
        assert res["hit_rule"], res


def test_call_matches_pallas_golden(golden):
    _, g, rays, tracer = golden
    got = tracer(*rays, int(g["seed"]), max_depth=int(g["max_depth"]),
                 t_min=float(g["t_min"])).double().numpy()
    want = g["radiance"].astype(np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    within = (np.abs(got - want) <= 1e-3 * np.abs(want).max()).all(-1)
    assert within.mean() >= 0.99, within.mean()
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=3e-3)


@pytest.mark.parametrize("name", ["cornell_box", "two_spheres", "triangles"])
def test_ray_planes_equal_camera_lanes(name):
    sd = tscenes.get(name)
    bake = ct.bake_scene(sd.scene)
    h, w, pix_base, n, seed, depth = 24, 24, 100, 300, -123457, 4
    o3, d3, tm = ct._camera_rays(sd.camera, h, w, pix_base, n,
                                 ct.rng_base(n, seed, "cpu"),
                                 torch.device("cpu"))
    o, d = torch.stack(o3, 1), torch.stack(d3, 1)
    got = ct.walk_packed_reference(bake, o, d, tm, seed, depth)
    want = ct.walk_packed_pixels_reference(bake, sd.camera, h, w, pix_base,
                                           n, seed, depth)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for rr in (0, 2):
        assert torch.equal(
            ct.trace_rays_reference(bake, o, d, tm, seed, depth, rr_start=rr),
            ct.trace_pixels_reference(bake, sd.camera, h, w, pix_base, n,
                                      seed, depth, rr_start=rr))


def test_walk_returns_bounce_data():
    sd = tscenes.get("two_spheres")
    tracer = ct.Tracer(sd.scene, "cpu")
    gen = torch.Generator().manual_seed(3)
    o, d, tm = sd.camera.get_rays(gen, torch.rand(64, generator=gen),
                                  torch.rand(64, generator=gen))
    rays = (o.contiguous(), d.contiguous(), tm)
    data = tracer.walk(*rays, 11, max_depth=3)
    planes = tracer.walk_packed(*rays, 11, max_depth=3)
    want = unpack_walk(planes, True, False)
    assert data.p.shape == (3, 64, 3) and data.scale is None
    for a, b in zip(data[:-1], want[:-1]):
        assert torch.equal(a, b)
    assert data.hit[0].any()


def test_ray_entries_check_their_inputs(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load kernels")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    tracer = ct.Tracer(tscenes.get("cornell_box").scene, "cpu")
    o = torch.zeros((8, 3))
    d = torch.ones((8, 3))
    tm = torch.zeros(8)
    before = ct.Tracer.ray_launches
    assert tracer(o, d, tm, 1, max_depth=2).shape == (8, 3)
    assert tracer.walk_packed(o, d, tm, 1, max_depth=2)[0].shape == (2, 8)
    assert ct.Tracer.ray_launches == before  # plain versions: no launch
    for bad in ((o.double(), d, tm), (o, d[:, :2], tm), (o, d, tm[:4]),
                (o.T, d, tm)):
        with pytest.raises(ValueError, match="contiguous"):
            tracer.walk_packed(*bad, 1)
        with pytest.raises(ValueError, match="contiguous"):
            tracer(*bad, 1)
