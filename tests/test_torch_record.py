"""The port's record walk (plain version, CPU) against the JAX megakernel.

The JAX side runs `PallasTracer.walk_packed_pixels` in interpret mode, as
the JAX package's own tests run it on the CPU; both sides get the same
scene tables, camera and int32 seed.

The rule against JAX (`cuda_trace.record_agreement`): bits 16-18 (hit,
cont, miss) are compared everywhere and bits 0-15 (mat) only where bit 16
is set, since a dead TPU lane stores the stale mat of its frozen ray.  Every
lane must agree at bounce 0 (the camera ray uses no transcendental), and
>= 99% of lanes over all bounces: torch's and XLA's sin/cos differ by an
ulp on a few percent of the scatter draws, which can send a ray that grazes
an edge elsewhere after a bounce.  Within the port, the record walk and the
forward walk trace the same paths, so their radiance is compared exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu_torch.convert import camera_from_numpy
from raytracing_gpu_tpu_torch.engine.integrator import shade_packed
from raytracing_gpu_tpu_torch.engine.diff import get_params
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import build
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct

torch.set_num_threads(1)

H = W = 24
DEPTH = 3
LANE_FLOOR = 0.99


@pytest.fixture(scope="module")
def setup():
    jsd = jscenes.get("cornell_box")
    tsd = tscenes.get("cornell_box")
    cam = camera_from_numpy({f.name: np.asarray(getattr(jsd.camera, f.name))
                             for f in dataclasses.fields(tsd.camera)})
    return pt.PallasTracer(jsd.scene), jsd.camera, tsd, cam


def _seed(i):
    return int(np.random.default_rng(71 + i).integers(-2**31, 2**31 - 1))


@pytest.mark.parametrize("pix_base,n,i", [
    (0, H * W, 0),    # the whole 24x24 image
    (500, 200, 1),    # runs past the image: ids clamp to the last pixel
])
def test_record_plane_matches_jax_walk(setup, pix_base, n, i):
    jtr, jcam, tsd, cam = setup
    assert not jtr.need_p and not jtr.need_uv  # Cornell: packed plane only
    seed = _seed(i)
    planes = jtr.walk_packed_pixels(jcam, H, W, pix_base, n, jnp.int32(seed),
                                    max_depth=DEPTH)
    want = np.asarray(planes[0]).reshape(DEPTH, -1)[:, :n]
    got = ct.Tracer(tsd.scene, "cpu").walk_packed_pixels(
        cam, H, W, pix_base, n, seed, max_depth=DEPTH)[0]
    assert got.dtype == torch.int32 and tuple(got.shape) == (DEPTH, n)
    agree = ct.record_agreement(got, want)
    assert agree["first_bounce"], agree
    assert agree["lane_frac"] >= LANE_FLOOR, agree
    # every path starts alive: bounce 0 is a hit or a miss on every lane
    assert ((got[0] & (ct.HIT_BIT | ct.MISS_BIT)) != 0).all()


@pytest.mark.parametrize("depth", [1, 4])
def test_record_and_forward_trace_the_same_paths(setup, depth):
    _, _, tsd, cam = setup
    tracer = ct.Tracer(tsd.scene, "cpu")
    seed = _seed(2)
    plane = tracer.walk_packed_pixels(cam, H, W, 0, H * W, seed,
                                      max_depth=depth)[0]
    fwd = tracer.trace_pixels(cam, H, W, 0, H * W, seed, max_depth=depth)
    params = get_params(tsd.scene, "cpu")
    rad = shade_packed(tsd.scene, params, plane, need_p=False, need_uv=False)
    np.testing.assert_array_equal(rad.numpy(), fwd.numpy())
    assert float(fwd.sum()) > 0.0


def test_record_words_are_well_formed(setup):
    _, _, tsd, cam = setup
    plane = ct.Tracer(tsd.scene, "cpu").walk_packed_pixels(
        cam, H, W, 0, H * W, _seed(3), max_depth=6)[0].to(torch.int64)
    hit = (plane & ct.HIT_BIT) != 0
    cont = (plane & ct.CONT_BIT) != 0
    miss = (plane & ct.MISS_BIT) != 0
    assert not (hit & miss).any() and (hit | ~cont).all()
    # a bounce is live only after a continued one, and a dead one is 0
    live = hit | miss
    assert torch.equal(live[1:], live[1:] & cont[:-1])
    assert (plane[~live] == 0).all()
    assert ((plane & 0xFFFF)[hit] < len(tsd.scene.materials.kind)).all()
    assert ((plane & 0xFFFF)[miss] == 0).all()


def test_tables_carry_material_ids(setup):
    _, _, tsd, _ = setup
    tracer = ct.Tracer(tsd.scene, "cpu")
    rects = tracer.rect_table.numpy()
    boxes = tracer.box_table.numpy()
    sc = tsd.scene
    np.testing.assert_array_equal(rects[:, ct.RECT_SH + ct.SH_MAT],
                                  sc.rects.mat_id[sc.rects.active])
    np.testing.assert_array_equal(boxes[:, ct.BOX_SH + ct.SH_MAT],
                                  sc.boxes.mat_id[sc.boxes.active])
    assert (rects[:, ct.RECT_SH + ct.SH_TEXK] == 0).all()  # solid


def test_cpu_record_never_touches_the_library(setup, monkeypatch):
    _, _, tsd, cam = setup

    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load kernels")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    before = ct.Tracer.record_launches
    tracer = ct.Tracer(tsd.scene, "cpu")
    got = tracer.bind_record(cam, H, W, max_depth=2)(0, 256, 5)[0]
    np.testing.assert_array_equal(
        got.numpy(), ct.walk_packed_pixels_reference(
            tracer.bake, cam, H, W, 0, 256, 5, max_depth=2)[0].numpy())
    assert ct.Tracer.record_launches == before
    with pytest.raises(ValueError, match="positive"):
        tracer.walk_packed_pixels(cam, H, W, 0, 0, 5)


def test_record_agreement_ignores_dead_lane_mat_bits():
    want = np.array([[ct.HIT_BIT | ct.CONT_BIT | 2, ct.MISS_BIT],
                     [3, ct.HIT_BIT | 1]], np.int32)  # lane 0 dead, stale 3
    same = want.copy()
    same[1, 0] = 0
    res = ct.record_agreement(same, want)
    assert res["bit_rule"] and res["lane_frac"] == 1.0
    assert res["exact_frac"] == 0.75
    moved = same.copy()
    moved[1, 1] = ct.HIT_BIT | 2                     # another material
    res = ct.record_agreement(moved, want)
    assert not res["bit_rule"] and res["first_bounce"]
    assert res["lane_frac"] == 0.5 and res["hit_mat_frac"] == 0.5
