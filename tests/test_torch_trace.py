"""The port's `trace_pixels` (plain version, CPU) against the JAX megakernel.

The JAX side runs `PallasTracer.trace_pixels` in interpret mode, as the
JAX package's own tests run it on the CPU, with `sub=8` to keep its tile
small (the lane ids, and so the random numbers, do not depend on `sub`).
Both sides get the same scene tables, camera and int32 seed.

Tolerances: depth 1 allclose(rtol=1e-5, atol=1e-5); deeper, >= 99% of
lanes within atol 1e-3 * max and channel means within 1e-3 relative
(transcendentals may differ by a few ulp between XLA and torch, which can
send a path elsewhere after a bounce).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu_torch import compile_renderer
from raytracing_gpu_tpu_torch.convert import camera_from_numpy
from raytracing_gpu_tpu_torch.core.config import RenderSettings
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import build
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct

torch.set_num_threads(1)

H = W = 64


@pytest.fixture(scope="module")
def setup():
    jsd = jscenes.get("cornell_box")
    tsd = tscenes.get("cornell_box")
    cam = camera_from_numpy({f.name: np.asarray(getattr(jsd.camera, f.name))
                             for f in dataclasses.fields(tsd.camera)})
    return pt.PallasTracer(jsd.scene), jsd.camera, tsd, cam


def _seed(i):
    return int(np.random.default_rng(31 + i).integers(-2**31, 2**31 - 1))


def assert_matches(got, want, depth):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    if depth <= 1:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    err = np.abs(got - want)
    within = (err <= 1e-3 * np.abs(want).max()).all(-1).mean()
    assert within >= 0.99, within
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=1e-3)


@pytest.mark.parametrize("depth,pix_base,n,i", [
    (1, 0, 4096, 0),      # the whole 64x64 image, one seed
    (1, 3500, 1024, 1),   # runs past the image: ids clamp to the last pixel
    (3, 0, 4096, 2),
])
def test_trace_pixels_matches_jax(setup, depth, pix_base, n, i):
    jtr, jcam, tsd, cam = setup
    seed = _seed(i)
    want = jtr.trace_pixels(jcam, H, W, pix_base, n, jnp.int32(seed),
                            max_depth=depth, sub=8)
    tracer = ct.Tracer(tsd.scene, "cpu")
    got = tracer.trace_pixels(cam, H, W, pix_base, n, seed, max_depth=depth)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, 3)
    assert_matches(got.numpy(), np.asarray(want), depth)


def test_cpu_tracer_never_touches_the_library(setup, monkeypatch):
    _, _, tsd, cam = setup

    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load kernels")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    before = ct.Tracer.launches
    tracer = ct.Tracer(tsd.scene, "cpu")
    out = tracer.trace_pixels(cam, H, W, 0, 256, 5, max_depth=2)
    assert out.device.type == "cpu" and torch.isfinite(out).all()
    np.testing.assert_array_equal(
        out.numpy(), ct.trace_pixels_reference(tracer.bake, cam, H, W, 0, 256,
                                               5, max_depth=2).numpy())
    np.testing.assert_array_equal(
        out.numpy(), tracer.bind(cam, H, W, max_depth=2)(0, 256, 5).numpy())
    assert ct.Tracer.launches == before


def test_cuda_request_without_cuda_raises(setup, monkeypatch):
    _, _, tsd, cam = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ct.Tracer(tsd.scene, "cuda")
    st = RenderSettings(image_width=16, aspect_ratio=1.0, spp_per_chunk=1,
                        num_chunks=1, max_depth=2)
    with pytest.raises(RuntimeError, match="is_available"):
        compile_renderer(tsd.scene, cam, st, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        ct.pcg_uniform(1, 16, 0, "cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        ct.Tracer(tsd.scene, "meta")
