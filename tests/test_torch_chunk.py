"""The megakernel route's chunk (`Tracer.bind_chunk`, one launch a sample
chunk on the card) on the CPU, where it runs `trace_chunk_reference`.

At 48x40 with waves of 1,024 pixels (1,920 pixels in two waves, the last
one padded to 2,048 rows), 3 spp:

- `compile_renderer(device="cpu")` equals the per-wave plain loop (each
  (sample, wave)'s `trace_pixels_reference` added in order into zeros) bit
  for bit on every row, as the kernel's chunk equals its waves on the card;
- it matches the JAX package's `compile_renderer(engine="pallas")` chunk
  (interpret mode) at depth 3, the goldens' depth: >= 99% of rows within
  atol 1e-3 * max, as tests/test_torch_render.py asks, and the channel
  means of those rows within 1e-3 relative.  torch's and XLA's
  sin/cos/log/exp on the CPU differ by an ulp here and there, so now and
  then one path of a chunk goes elsewhere: on the Cornell chunk drawn
  here, one of 6,144 paths reaches the light in one package only, that
  row differs by 4.93, and it alone moves a channel mean of all 2,048 rows
  by 6.7e-3.  The rows past the atol (at most 1%) are that divergence; the
  means over the others still see any bias of the rest;
- Cornell, `first`, `cornell_smoke` and big_scene1 (with its lens and
  shutter, under the sphere BVH's route), and `cornell_smoke` at depth 8
  with russian roulette from bounce 2 against the per-wave loop.
"""

import jax
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.core.config import RenderSettings as JaxSettings
from raytracing_gpu_tpu.engine.render import compile_renderer as jax_compile
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu_torch import RenderSettings, compile_renderer
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct

torch.set_num_threads(1)

WIDTH, ASPECT, BATCH, SPP = 48, 1.2, 1024, 3
ROWS = 2048


def _settings(depth, rr_start=0):
    return RenderSettings(image_width=WIDTH, aspect_ratio=ASPECT,
                          spp_per_chunk=SPP, num_chunks=1, max_depth=depth,
                          ray_batch=BATCH, rr_start=rr_start)


def _per_wave_loop(scene, camera, st, base):
    """The megakernel route's chunk as it was computed a wave at a time."""
    bake = ct.bake_scene(scene)
    h, w, b = st.image_height, st.image_width, st.ray_batch
    sums = torch.zeros((ROWS, 3), dtype=torch.float32)
    for s in range(st.spp_per_chunk):
        for bid in range(ROWS // b):
            sums[bid * b:(bid + 1) * b] += ct.trace_pixels_reference(
                bake, camera, h, w, bid * b, b, ct.wave_seed(base, s, bid),
                st.max_depth, st.t_min, rr_start=st.rr_start)
    return sums


def assert_sums_match(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    close = (np.abs(got - want) <= 1e-3 * np.abs(want).max()).all(-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(got[close].mean(0), want[close].mean(0),
                               rtol=1e-3)


@pytest.mark.parametrize("name", ["cornell_box", "first", "cornell_smoke",
                                  "big_scene1"])
def test_chunk_equals_waves_and_jax(name):
    jsd, tsd = jscenes.get(name), tscenes.get(name)
    st = _settings(depth=3)
    assert (st.image_height, st.image_width) == (40, 48)
    key = jax.random.PRNGKey(np.random.default_rng(96).integers(0, 2**31))
    base = int(pt.chunk_seed(key))
    chunk = compile_renderer(tsd.scene, tsd.camera, st, device="cpu")
    assert chunk.engine_name == "megakernel"
    got = chunk(base)
    assert got.shape == (ROWS, 3) and got.dtype == torch.float32
    assert torch.equal(got, _per_wave_loop(tsd.scene, tsd.camera, st, base))
    jst = JaxSettings(image_width=WIDTH, aspect_ratio=ASPECT,
                      spp_per_chunk=SPP, num_chunks=1, max_depth=3,
                      ray_batch=BATCH)
    jchunk = jax_compile(jsd.scene, jsd.camera, jst, engine="pallas")
    assert jchunk.engine_name == "megakernel"
    assert_sums_match(got.numpy(), np.asarray(jchunk(key)))


def test_chunk_with_russian_roulette_equals_waves():
    tsd = tscenes.get("cornell_smoke")
    st = _settings(depth=8, rr_start=2)
    chunk = compile_renderer(tsd.scene, tsd.camera, st, device="cpu")
    got = chunk(1234567)
    assert torch.equal(got, _per_wave_loop(tsd.scene, tsd.camera, st,
                                           1234567))
    plain = compile_renderer(tsd.scene, tsd.camera, st.with_(rr_start=0),
                             device="cpu")(1234567)
    assert not torch.equal(got, plain) and bool(torch.isfinite(got).all())


def test_bind_chunk_takes_what_the_route_gives_it():
    tsd = tscenes.get("cornell_box")
    tracer = ct.Tracer(tsd.scene, "cpu")
    launch = tracer.bind_chunk(tsd.camera, 40, 48, 2, 0.001, 0, BATCH, 1)
    assert launch(5).shape == (ROWS, 3)
    assert ct.chunk_rows(40, 48, 1920) == 1920
    with pytest.raises(ValueError):
        tracer.bind_chunk(tsd.camera, 40, 48, 2, 0.001, 0, BATCH, 0)
    with pytest.raises(ValueError):
        ct.chunk_rows(40, 48, 0)
