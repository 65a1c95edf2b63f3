"""Kernel 1b's uv planes, on the CPU: the record walk of image-textured
scenes (`need_uv`).

The port's plain record walk (`walk_packed_pixels_reference`,
`walk_packed_reference`; the CUDA kernel equals them on the card) against
the Pallas kernel's planes in interpret mode, pinned by
`tools/make_torch_goldens.py`:

- `<probe>_uv32.npz` for the image probes of `models/probes.py` (the
  probe box: rect, box, medium, rotated sphere and mesh uv; 70 image
  spheres under the sphere BVH; a small image mesh), and
  `earth_fused32.npz` (`earth` with a synthetic map, a lens): width 32,
  2 spp, depth 3 (earth 4), waves of 512 rays;
- `earth_rays.npz`: 512 JAX camera rays of `earth` through `walk_packed`
  (kernel 1c), depth 8.

The packed words are held by the bit rule (`cuda_trace.record_agreement`:
every lane at bounce 0 whose camera ray is the same on both sides, >= 99%
of lanes over all bounces), and u and v where bit 16 is set, on the lanes
that agree, by `cuda_trace.uv_agreement`: at bounce 0 every entry within
the golden's own limit (`cuda_trace.UV_LIMIT0`: 1e-4, and 1e-3 for the
small image spheres) and >= 99% within UV_CLOSE = 1e-4, and >= 99% of all
entries within HIT_CLOSE = 2e-3, with u compared modulo 1 (a sphere's u
wraps at its seam).  XLA on the CPU contracts multiply-adds, so uv is not
bit-exact even at bounce 0: a rect's hit coordinate moves by an ulp, and a
small sphere's hit point, and so its normal and uv, by up to ~3e-4.  A uv
plane rounded to bfloat16 fails it.

The fused chunk over `earth_fused32`'s own planes against the JAX fused
chunk's primal and L2-loss gradients, `atlas_data`'s included: rtol 2e-4,
atol 1e-7 (the rule of tests/test_torch_record_p.py).
"""

import os

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu_torch import Camera, RenderSettings, SceneBuilder
from raytracing_gpu_tpu_torch.engine import diff, fused_diff, render
from raytracing_gpu_tpu_torch.models import probes
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
UV_PROBES = ("image_probe", "image_spheres", "image_mesh")
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-7


def _golden(name):
    g = np.load(os.path.join(DATA, f"{name}.npz"))
    st = RenderSettings(image_width=int(g["image_width"]),
                        aspect_ratio=float(g["aspect_ratio"]),
                        spp_per_chunk=int(g["spp_per_chunk"]), num_chunks=1,
                        max_depth=int(g["max_depth"]),
                        ray_batch=int(g["ray_batch"]), t_min=float(g["t_min"]))
    return g, st


def _earth(g):
    return tscenes.earth(probes.synthetic_image(*(int(x) for x in
                                                  g["earth_map"])))


def _scene(name, g):
    """(scene, camera) of a golden."""
    if name.startswith("earth"):
        sd = _earth(g)
        return sd.scene, sd.camera
    scene, cam, _ = getattr(probes, name.replace("_uv32", ""))(SceneBuilder,
                                                               Camera)
    return scene, cam


def _waves(g, st):
    h, w, b = st.image_height, st.image_width, st.ray_batch
    return [(bid * b, b, ct.wave_seed(int(g["base"]), s, bid))
            for s in range(st.spp_per_chunk)
            for bid in range(-(-h * w // b))]


def _walk(tracer, cam, g, st):
    """The port's planes of every wave of a golden's chunk, stacked as the
    golden stacks them, and the lanes whose lens rounds as XLA's."""
    waves = _waves(g, st)
    planes = [tracer.walk_packed_pixels(cam, st.image_height, st.image_width,
                                        *wv, st.max_depth, st.t_min)
              for wv in waves]
    same = None
    if "lens_cs" in g:
        same = np.stack([(ct.lens_cos_sin(seed, n).numpy()
                          == g["lens_cs"][i]).all(0)
                         for i, (_, n, seed) in enumerate(waves)])
    return (torch.stack([p[0] for p in planes]),
            torch.stack([torch.stack(p[-2:]) for p in planes]), same)


@pytest.mark.parametrize("name", [f"{p}_uv32" for p in UV_PROBES]
                         + ["earth_fused32"])
def test_uv_planes_match_pallas_golden(name):
    g, st = _golden(name)
    scene, cam = _scene(name, g)
    tracer = ct.Tracer(scene, "cpu")
    assert tracer.need_uv and not tracer.need_p
    assert not tracer.supports_forward  # the forward kernel refuses them
    packed, uv, same = _walk(tracer, cam, g, st)
    rec = ct.record_agreement(packed, g["planes"], same)
    assert rec["first_bounce"] and rec["lane_frac"] >= 0.99, rec
    limit0 = ct.UV_LIMIT0[name]
    res = ct.uv_agreement(packed, g["planes"], uv, g["uv"], limit0)
    assert res["rule"] and res["entries"] > 100, res
    # the rule sees a precision loss: the same planes rounded to bfloat16
    bf16 = uv.to(torch.bfloat16).to(torch.float32)
    assert not ct.uv_agreement(packed, g["planes"], bf16, g["uv"],
                               limit0)["rule"]
    # every uv path is exercised, and every planes' value is a uv
    assert float(uv.min()) >= 0.0 and float(uv.max()) <= 1.0
    if name == "image_probe_uv32":
        mat = (g["planes"] & 0xFFFF)[((g["planes"] >> 16) & 1) == 1]
        box = scene.boxes.mat_id[scene.boxes.active & ~scene.boxes.medium]
        sph = scene.spheres.mat_id[scene.spheres.active
                                   & ~scene.spheres.medium]
        med = scene.boxes.mat_id[scene.boxes.active & scene.boxes.medium]
        tri = scene.triangles.mat_id[scene.triangles.active]
        for m in (box[0], sph[0], med[0], tri[0]):
            assert (mat == m).sum() > 0, m


def test_box_winner_keeps_the_closest_rect_uv():
    """The Pallas box update passes no uv (pallas_trace.py:1041-1044): a
    box winner's uv is the closest rect hit's, or 0.  A ray from inside the
    probe box's footprint straight down hits the box's top and, behind it,
    the floor rect: its uv is the floor's at the ray's (x, z)."""
    scene, cam, _ = probes.image_probe(SceneBuilder, Camera)
    bake = ct.bake_scene(scene)
    x, z = torch.tensor([300.0, 340.0]), torch.tensor([380.0, 400.0])
    o = torch.stack([x, torch.full_like(x, 500.0), z], dim=1)
    d = torch.tensor([[0.0, -1.0, 0.0]]).expand(2, 3).contiguous()
    planes = ct.walk_packed_reference(bake, o, d, torch.zeros(2), 5, 1)
    box_mat = int(scene.boxes.mat_id[0])
    assert ((planes[0][0] & 0xFFFF) == box_mat).all()
    assert ((planes[0][0] >> 16) & 1).all()
    # the floor rect spans [0, 555] in x and z
    torch.testing.assert_close(planes[1][0], x / 555.0, rtol=0, atol=1e-6)
    torch.testing.assert_close(planes[2][0], z / 555.0, rtol=0, atol=1e-6)


def test_earth_ray_planes_match_pallas_golden():
    g = np.load(os.path.join(DATA, "earth_rays.npz"))
    sd = _earth(g)
    tracer = ct.Tracer(sd.scene, "cpu")
    rays = [torch.from_numpy(np.ascontiguousarray(g[k]))
            for k in ("o", "d", "tm")]
    planes = tracer.walk_packed(*rays, int(g["seed"]),
                                max_depth=int(g["max_depth"]))
    assert len(planes) == 3
    rec = ct.record_agreement(planes[0], g["planes"])
    assert rec["first_bounce"] and rec["lane_frac"] >= 0.99, rec
    res = ct.uv_agreement(planes[0], g["planes"], torch.stack(planes[1:]),
                          g["uv"], ct.UV_LIMIT0["earth_rays"])
    assert res["rule"] and res["entries"] > 100, res
    data = tracer.walk(*rays, int(g["seed"]), max_depth=int(g["max_depth"]))
    assert torch.equal(data.u, planes[1]) and torch.equal(data.v, planes[2])


def test_earth_fused_chunk_matches_jax():
    g, st = _golden("earth_fused32")
    sd = _earth(g)
    waves = _waves(g, st)
    golden_planes = {wv: (torch.from_numpy(g["planes"][i]),
                          *torch.from_numpy(g["uv"][i]).unbind(0))
                     for i, wv in enumerate(waves)}
    params = diff.get_params(sd.scene, "cpu")
    chunk = fused_diff.fused_chunk_from_walk(
        sd.scene, lambda pb, n, seed: golden_planes[(pb, n, seed)], st,
        device="cpu")
    base = int(g["base"])
    out = chunk(params, base)
    np.testing.assert_allclose(out.numpy(), g["primal"], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    _, grads = diff.value_and_grad(params, lambda p: chunk(p, base),
                                   torch.full_like(out, float(g["target"])))
    for k in diff.PARAM_KEYS:
        np.testing.assert_allclose(grads[k].numpy(), g[f"grad_{k}"],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    assert (grads["atlas_data"] != 0).sum() > 100


def test_earth_fused_chunk_on_the_port_walk():
    # the port's own record walk (in-kernel camera rays, uv planes) through
    # the chunk: the record-walk route's training chunk on camera rays
    g, st = _golden("earth_fused32")
    sd = _earth(g)
    chunk = fused_diff.compile_fused_param_renderer(sd.scene, sd.camera, st,
                                                    device="cpu")
    params = diff.get_params(sd.scene, "cpu")
    base = int(g["base"])
    out = chunk(params, base)
    # the walks agree with the golden's but for a lane or two (the lens
    # rounding): the chunk's channel means within the forward goldens'
    # 3e-3 relative
    mean, want = out.mean(0).numpy(), g["primal"].mean(0)
    np.testing.assert_allclose(mean, want, rtol=3e-3, atol=0)
    _, grads = diff.value_and_grad(params, lambda p: chunk(p, base),
                                   torch.full_like(out, float(g["target"])))
    assert (grads["atlas_data"] != 0).sum() > 100


def test_image_scene_renders_on_the_record_walk_route():
    g, _ = _golden("earth_fused32")
    sd = _earth(g)
    st = RenderSettings(image_width=16, aspect_ratio=1.0, spp_per_chunk=2,
                        num_chunks=1, max_depth=4, ray_batch=128)
    chunk = render.compile_renderer(sd.scene, sd.camera, st, device="cpu")
    assert chunk.engine_name == "record-walk"
    sums = chunk(11)
    assert sums.shape == (256, 3) and bool(torch.isfinite(sums).all())
    # the same waves through the differentiable route's chunk
    pchunk = render.compile_param_renderer(sd.scene, sd.camera, st,
                                           device="cpu")
    assert pchunk.engine_name == "record-walk"
    torch.testing.assert_close(pchunk(diff.get_params(sd.scene, "cpu"), 11),
                               sums, rtol=0, atol=0)


def test_wavefront_record_walk_writes_uv():
    # the hit kernel's resolved uv in the wavefront record walk's planes,
    # and atlas gradients through the shade under autograd
    sd = tscenes.backpack_standin((8, 8), probes.synthetic_image(16, 16, 9))
    st = RenderSettings(image_width=12, aspect_ratio=1.0, spp_per_chunk=1,
                        num_chunks=1, max_depth=3, ray_batch=144)
    chunk = render.compile_param_renderer(sd.scene, sd.camera, st,
                                          engine="wavefront", device="cpu")
    assert chunk.engine_name == "wavefront-record"
    params = diff.get_params(sd.scene, "cpu")
    _, grads = diff.value_and_grad(params, lambda p: chunk(p, 5),
                                   torch.zeros(144, 3))
    assert (grads["atlas_data"] != 0).sum() > 0
