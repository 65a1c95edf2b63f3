"""The regenerative wavefront renderer and the routing of `compile_renderer`,
on the CPU.

- The engine tags equal the JAX package's `compile_renderer(engine=
  "pallas")` for the same scene and settings.
- A chunk is deterministic for one base seed; on a scene where every ray
  misses, every pixel receives exactly `spp` deposits (the stream is
  exhausted and the ring drains and flushes every pixel once).
- The random streams differ from JAX's threefry, so the chunk agrees with
  the pinned JAX regen chunk (`big_scene1_regen.npz`) and with the port's
  megakernel route statistically: per channel, the mean over pixels of the
  per-pixel difference of the two estimates lies within 4 standard errors
  of 0 (the pixels are independent, so the standard error is the spread of
  the differences over the square root of the pixel count).
"""

import os

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.core.config import RenderSettings as JSettings
from raytracing_gpu_tpu.engine.render import compile_renderer as jcompile
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu_torch import (RenderSettings, SceneBuilder, cli,
                                     compile_renderer)
from raytracing_gpu_tpu_torch.engine.render import _grid_geometry
from raytracing_gpu_tpu_torch.engine.wavefront import compile_regen_renderer
from raytracing_gpu_tpu_torch.models import scenes as tscenes

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
Z_LIMIT = 4.0


@pytest.fixture(scope="module")
def golden():
    g = np.load(os.path.join(DATA, "big_scene1_regen.npz"))
    st = RenderSettings(image_width=int(g["image_width"]),
                        aspect_ratio=float(g["aspect_ratio"]),
                        spp_per_chunk=int(g["spp_per_chunk"]), num_chunks=1,
                        max_depth=int(g["max_depth"]),
                        ray_batch=int(g["ray_batch"]), t_min=float(g["t_min"]))
    return g, st


@pytest.fixture(scope="module")
def regen_chunk(golden):
    """The port's regen chunk at the golden's settings, with its stats."""
    g, st = golden
    sd = tscenes.get("big_scene1")
    chunk = compile_regen_renderer(sd.scene, sd.camera, st, debug_stats=True,
                                   device="cpu")
    sums, stats = chunk(20241)
    return sums.numpy()[:st.num_pixels] / st.spp_per_chunk, stats


def z_scores(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per channel: mean of (a - b) over pixels in standard errors."""
    diff = (a - b).astype(np.float64)
    return diff.mean(0) / (diff.std(0, ddof=1) / np.sqrt(len(diff)))


@pytest.mark.parametrize("name,depth,spp", [
    ("big_scene1", 16, 16), ("big_scene1", 16, 8), ("big_scene1", 4, 16),
    ("cornell_box", 16, 16), ("cornell_smoke", 16, 16)])
def test_routing_tags_equal_jax(name, depth, spp):
    jsd, tsd = jscenes.get(name), tscenes.get(name)
    kw = dict(image_width=32, aspect_ratio=jsd.aspect, spp_per_chunk=spp,
              num_chunks=1, max_depth=depth, ray_batch=512)
    want = jcompile(jsd.scene, jsd.camera, JSettings(**kw),
                    engine="pallas").engine_name
    got = compile_renderer(tsd.scene, tsd.camera, RenderSettings(**kw),
                           device="cpu").engine_name
    assert got == want
    assert got == ("regen" if (name, depth, spp) == ("big_scene1", 16, 16)
                   else "megakernel")


def test_regen_is_deterministic_for_one_seed():
    sd = tscenes.get("big_scene1")
    st = RenderSettings(image_width=16, aspect_ratio=sd.aspect,
                        spp_per_chunk=16, num_chunks=1, max_depth=8,
                        ray_batch=256)
    chunk = compile_renderer(sd.scene, sd.camera, st, device="cpu")
    assert chunk.engine_name == "regen"
    a, b, c = chunk(5), chunk(5), chunk(6)
    assert tuple(a.shape) == (_grid_geometry(st)[3], 3) == (144, 3)
    assert torch.isfinite(a).all() and float(a.min()) > 0.0
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_every_pixel_receives_spp_deposits_when_all_rays_miss():
    # 100 spheres (a BVH) behind a camera: every camera ray misses, dies at
    # its first step and deposits the background once.  Powers of two sum
    # exactly, so each pixel's sum is spp times the background, bit for
    # bit.  2,304 pixels pass through a 512-row ring in drains of 32.
    b = SceneBuilder(background=(1.0, 0.5, 0.25))
    for i in range(100):
        b.sphere((30.0 + i % 10, i // 10, 0.0), 0.3, b.lambertian((0.5,) * 3))
    sd = tscenes.get("big_scene1")
    st = RenderSettings(image_width=64, aspect_ratio=sd.aspect,
                        spp_per_chunk=16, num_chunks=1, max_depth=8,
                        ray_batch=512)
    chunk = compile_regen_renderer(b.build(), sd.camera, st,
                                   debug_stats=True, device="cpu")
    sums, stats = chunk(3)
    npix = st.num_pixels
    want = np.broadcast_to(np.float32([16.0, 8.0, 4.0]), (npix, 3))
    np.testing.assert_array_equal(sums.numpy()[:npix], want)
    assert not sums[npix:].any()
    assert stats["stream"] == npix * 16  # 2,304 is a whole number of drains
    assert stats["iterations"] == npix * 16 // 512


def test_regen_matches_jax_golden_statistically(golden, regen_chunk):
    g, st = golden
    got, stats = regen_chunk
    want = g["sums"][:st.num_pixels] / st.spp_per_chunk
    assert got.shape == want.shape == (1296, 3) and np.isfinite(got).all()
    z = z_scores(got, want)
    assert (np.abs(z) < Z_LIMIT).all(), z
    assert stats["stream"] == int(g["stream"])  # the same stream length
    # the step counts follow the paths' lengths: within 10% of JAX's
    assert abs(stats["iterations"] / int(g["iterations"]) - 1) < 0.1


def test_regen_agrees_with_the_megakernel_route(golden, regen_chunk):
    g, st = golden
    got, _ = regen_chunk
    sd = tscenes.get("big_scene1")
    mst = st.with_(spp_per_chunk=2)  # below 16 spp: the megakernel route
    mega = compile_renderer(sd.scene, sd.camera, mst, device="cpu")
    assert mega.engine_name == "megakernel"
    other = mega(77).numpy()[:st.num_pixels] / mst.spp_per_chunk
    z = z_scores(got, other)
    assert (np.abs(z) < Z_LIMIT).all(), z


def test_regen_refuses_media():
    sd = tscenes.get("cornell_smoke")
    st = RenderSettings(image_width=16, aspect_ratio=sd.aspect,
                        spp_per_chunk=16, num_chunks=1, max_depth=8,
                        ray_batch=256)
    with pytest.raises(ValueError, match="no media"):
        compile_regen_renderer(sd.scene, sd.camera, st, device="cpu")


def test_cli_render_logs_the_regen_engine(tmp_path, capsys):
    out = tmp_path / "b.png"
    assert cli.main(["render", "big_scene1", "--device", "cpu", "--width",
                     "16", "--spp", "16", "--chunks", "1", "--depth", "8",
                     "--ray-batch", "256", "-o", str(out)]) == 0
    assert "render engine: regen on cpu" in capsys.readouterr().err
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "big_scene1" in tscenes.names()
