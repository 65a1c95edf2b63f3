"""Kernel 1b beyond the packed plane, on the CPU: the record walk's
hit-point planes (`need_p`) and its sphere- and triangle-BVH walks.

The port's plain record walk (`walk_packed_pixels_reference`, which the
CUDA kernel equals on the card) against the Pallas kernel's record planes,
pinned by `tools/make_torch_goldens.py` (`<scene>_rec32.npz`: width 32,
2 spp, depth 3, waves of 512 rays, the planes of
`PallasTracer.walk_packed_pixels` in interpret mode):

- the packed words under the bit rule (`cuda_trace.record_agreement`):
  every lane at bounce 0 whose camera ray is the same on both sides, and
  >= 99% of lanes over all bounces.  With a lens the camera ray uses cos
  and sin, which differ between torch and XLA by an ulp on a few lanes
  (the golden keeps XLA's, `lens_cs`); on big_scene1 one such lane grazes
  another sphere;
- the hit points where bit 16 is set, on the lanes that agree, under
  `cuda_trace.p_agreement`: at bounce 0 the hit golden's float rule (all
  within `HIT_LIMITS["p"]`, >= 99% within `HIT_CLOSE`; XLA contracts
  multiply-adds), and >= 99% of all entries within `HIT_LIMITS["p"]`.
  After a bounce the largest error grows with the path (a 0.2-radius
  sphere turns 1e-3 of p into 5e-3 of normal), so it is not bounded
  there.

The fused chunk over the golden's own planes (`two_spheres`) against the
JAX fused chunk's primal and L2-loss gradients: rtol 2e-4, atol 1e-7 (the
Cornell rule of tests/test_torch_diff.py).
"""

import os

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu_torch import RenderSettings
from raytracing_gpu_tpu_torch.engine import diff, fused_diff
from raytracing_gpu_tpu_torch.engine.integrator import shade_packed
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
REC_SCENES = ("two_spheres", "two_perlin_spheres", "big_scene1",
              "triangles")
P_SCENES = ("two_spheres", "two_perlin_spheres", "big_scene1")


def _golden(name):
    g = np.load(os.path.join(DATA, f"{name}_rec32.npz"))
    st = RenderSettings(image_width=int(g["image_width"]),
                        aspect_ratio=float(g["aspect_ratio"]),
                        spp_per_chunk=int(g["spp_per_chunk"]), num_chunks=1,
                        max_depth=int(g["max_depth"]),
                        ray_batch=int(g["ray_batch"]), t_min=float(g["t_min"]))
    return g, st


def _waves(g, st):
    h, w, b = st.image_height, st.image_width, st.ray_batch
    return [(bid * b, b, ct.wave_seed(int(g["base"]), s, bid))
            for s in range(st.spp_per_chunk) for bid in range(-(-h * w // b))]


@pytest.fixture(scope="module", params=REC_SCENES)
def walked(request):
    """(name, golden, settings, tracer, the port's planes of every wave)."""
    name = request.param
    g, st = _golden(name)
    tsd = tscenes.get(name)
    tracer = ct.Tracer(tsd.scene, "cpu")
    walk = tracer.bind_record(tsd.camera, st.image_height, st.image_width,
                              st.max_depth, st.t_min)
    planes = [walk(*wave) for wave in _waves(g, st)]
    return name, g, st, tracer, planes


def _same_rays(g, st):
    """The lanes whose camera ray torch makes as XLA does (no lens: all)."""
    if "lens_cs" not in g:
        return None
    return np.stack([
        (ct.lens_cos_sin(seed, n).numpy() == g["lens_cs"][i]).all(0)
        for i, (_, n, seed) in enumerate(_waves(g, st))])


def test_record_planes_match_pallas_golden(walked):
    name, g, st, tracer, planes = walked
    assert tracer.need_p == bool(g["need_p"]) == (name in P_SCENES)
    assert len(planes[0]) == (4 if tracer.need_p else 1)
    got = torch.stack([p[0] for p in planes])
    same = _same_rays(g, st)
    agree = ct.record_agreement(got, g["planes"], same)
    assert agree["first_bounce"], agree
    assert agree["lane_frac"] >= 0.99, agree
    if same is not None:  # only a few lanes' lens angles differ
        assert same.mean() >= 0.9, same.mean()


@pytest.mark.parametrize("name", P_SCENES)
def test_hit_points_match_pallas_golden(name):
    g, st = _golden(name)
    tsd = tscenes.get(name)
    tracer = ct.Tracer(tsd.scene, "cpu")
    planes = [tracer.walk_packed_pixels(tsd.camera, st.image_height,
                                        st.image_width, *wave, st.max_depth,
                                        st.t_min) for wave in _waves(g, st)]
    got = torch.stack([p[0] for p in planes])
    got_p = torch.stack([torch.stack(p[1:]) for p in planes])
    res = ct.p_agreement(got, g["planes"], got_p, g["p"])
    assert res["hit_rule"], res
    assert res["entries"] > 1000, res
    # the kernel's own rule: 0 wherever the bounce did not hit
    missed = (got & ct.HIT_BIT) == 0
    assert (got_p[missed[:, None].expand_as(got_p)] == 0).all()


@pytest.mark.parametrize("name", P_SCENES)
def test_record_and_forward_trace_the_same_paths_with_p(name):
    tsd = tscenes.get(name)
    tracer = ct.Tracer(tsd.scene, "cpu")
    h, w, n, seed = 24, 24, 576, 7
    planes = tracer.walk_packed_pixels(tsd.camera, h, w, 0, n, seed, 4)
    fwd = tracer.trace_pixels(tsd.camera, h, w, 0, n, seed, 4)
    rad = shade_packed(tsd.scene, diff.get_params(tsd.scene, "cpu"),
                       *planes, need_p=True, need_uv=False)
    # the same paths; the shade's albedo (`c1 + odd * (c2 - c1)`, the JAX
    # shade's form) may round an ulp off the kernel's select
    torch.testing.assert_close(rad, fwd, rtol=1e-5, atol=1e-6)
    assert float(fwd.sum()) > 0.0


def test_record_instantiation_drops_the_texture_bits():
    tracer = ct.Tracer(tscenes.get("two_perlin_spheres").scene, "cpu")
    feats = tracer.bake.features()
    assert feats & ct.FEAT_PERLIN and feats & ct.FEAT_CHECKER
    assert tracer._record_features() == feats & (
        ct.FEAT_SPHERES | ct.FEAT_MEDIA | ct.FEAT_SPHERE_BVH
        | ct.FEAT_TRI_BVH)


def test_fused_chunk_on_golden_planes_matches_jax():
    g, st = _golden("two_spheres")
    tsd = tscenes.get("two_spheres")
    by_wave = {}
    for i, wave in enumerate(_waves(g, st)):
        by_wave[wave] = (torch.from_numpy(g["planes"][i]),
                         *torch.from_numpy(g["p"][i]).unbind(0))

    def walk(pix_base, n, seed):
        return by_wave[(pix_base, n, seed)]

    chunk = fused_diff.fused_chunk_from_walk(tsd.scene, walk, st,
                                             device="cpu")
    params = diff.get_params(tsd.scene, "cpu")
    base = int(g["base"])
    out = chunk(params, base)
    _, grads = diff.value_and_grad(params, lambda p: chunk(p, base),
                                   torch.full_like(out, float(g["target"])))
    np.testing.assert_allclose(out.numpy(), g["primal"], rtol=2e-4,
                               atol=1e-7)
    for k in diff.PARAM_KEYS:
        np.testing.assert_allclose(grads[k].numpy(), g[f"grad_{k}"],
                                   rtol=2e-4, atol=1e-7, err_msg=k)
    assert float(np.abs(g["grad_tex_c1"]).max()) > 0.0
