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
"""

import os

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu_torch import RenderSettings, compile_renderer
from raytracing_gpu_tpu_torch.engine import diff, fused_diff
from raytracing_gpu_tpu_torch.models import scenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct

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


def assert_matches(got, want, depth):
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape and torch.isfinite(got).all()
    exact = float((got == want).double().mean())
    assert exact >= EXACT_FLOOR, exact
    if depth <= 1:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    err = (got - want).abs()
    within = float((err <= 1e-3 * want.abs().max()).all(-1).double().mean())
    assert within >= 0.99, within
    torch.testing.assert_close(got.mean(0), want.mean(0), rtol=1e-3, atol=0)


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
    before = ct.Tracer.launches
    got = compile_renderer(sd.scene, sd.camera, st, dev)(int(g["base"]))
    assert ct.Tracer.launches == before + st.spp_per_chunk
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
                                    max_depth=depth)
    assert ct.Tracer.record_launches == before + 1
    want = ct.walk_packed_pixels_reference(tracer.bake, sd.camera, 64, 64, 0,
                                           4096, seed, max_depth=depth,
                                           device=dev)
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
                                  st.max_depth, st.t_min)
        for s in range(st.spp_per_chunk) for bid in range(h * w // b)])
    res = ct.record_agreement(got, g["planes"])
    assert res["first_bounce"] and res["lane_frac"] >= 0.99, res


@pytest.mark.parametrize("save_planes,walks", [(True, 4), (False, 8)])
def test_fused_chunk_matches_jax_golden(dev, save_planes, walks):
    g = np.load(GRAD_GOLDEN)
    st = _golden_settings(g)
    sd = scenes.get("cornell_box")
    chunk = fused_diff.compile_fused_param_renderer(
        sd.scene, sd.camera, st, save_planes=save_planes, device=dev)
    params = diff.get_params(sd.scene, dev)
    base = int(g["base"])
    before = ct.Tracer.record_launches
    out = chunk(params, base)
    _, grads = diff.value_and_grad(params, lambda p: chunk(p, base),
                                   torch.full_like(out, float(g["target"])))
    assert ct.Tracer.record_launches == before + 4 + walks
    assert_matches(out.detach(), torch.from_numpy(g["primal"]), st.max_depth)
    for k in diff.PARAM_KEYS:
        torch.testing.assert_close(grads[k].cpu(),
                                   torch.from_numpy(g[f"grad_{k}"]),
                                   rtol=2e-4, atol=1e-7)
