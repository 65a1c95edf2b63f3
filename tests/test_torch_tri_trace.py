"""The forward paths of triangle scenes in the port, against the JAX package
on the CPU.

- The megakernel route's plain version (`trace_pixels_reference` with the
  triangle walk) against the Pallas megakernel's chunk of `triangles`
  (`triangles_32.npz`), under the dense scenes' golden rule: >= 99% of the
  pixels within 1e-3 of the largest value and every channel mean within
  3e-3 relative (tests/test_torch_spheres.py).
- The regen and the bounce-synchronous wavefront renderers on the small
  mesh scene (a 16 x 16 UV sphere of 512 triangles on the backpack's
  ground sphere, under its camera) against the pinned JAX regen chunk
  (`mesh_regen.npz`: 48x27, 16 spp, depth 8), statistically: the random
  streams differ from JAX's threefry, so per channel the mean over pixels
  of the per-pixel difference lies within 4 standard errors of 0.
- The CLI renders `triangles` on the megakernel route and `backpack` on the
  wavefront route, logging the engine.
"""

import os

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu_torch import RenderSettings, cli
from raytracing_gpu_tpu_torch import compile_renderer
from raytracing_gpu_tpu_torch.engine.wavefront import (
    compile_regen_renderer, compile_wavefront_renderer)
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
Z_LIMIT = 4.0


def mesh_sd():
    """The goldens' small mesh scene (`make_torch_goldens.mesh_scene`)."""
    return tscenes.backpack_standin((16, 16))


def settings_of(g) -> RenderSettings:
    return RenderSettings(image_width=int(g["image_width"]),
                          aspect_ratio=float(g["aspect_ratio"]),
                          spp_per_chunk=int(g["spp_per_chunk"]), num_chunks=1,
                          max_depth=int(g["max_depth"]),
                          ray_batch=int(g["ray_batch"]),
                          t_min=float(g["t_min"]))


def z_scores(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per channel: mean of (a - b) over pixels in standard errors."""
    diff = (a - b).astype(np.float64)
    return diff.mean(0) / (diff.std(0, ddof=1) / np.sqrt(len(diff)))


@pytest.fixture(scope="module")
def regen_golden():
    g = np.load(os.path.join(DATA, "mesh_regen.npz"))
    st = settings_of(g)
    return g, st, g["sums"][:st.num_pixels] / st.spp_per_chunk


def test_triangles_chunk_matches_pinned_golden():
    g = np.load(os.path.join(DATA, "triangles_32.npz"))
    st = settings_of(g)
    tsd = tscenes.get("triangles")
    chunk = compile_renderer(tsd.scene, tsd.camera, st, device="cpu")
    assert chunk.engine_name == "megakernel"
    got = chunk(int(g["base"])).numpy().astype(np.float64)
    want = g["sums"].astype(np.float64)
    assert got.shape == want.shape == (576, 3) and np.isfinite(got).all()
    within = (np.abs(got - want) <= 1e-3 * np.abs(want).max()).all(-1).mean()
    assert within >= 0.99, within
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=3e-3)


@pytest.mark.parametrize("name", ["triangles", "mesh"])
def test_plain_forward_counts_the_triangle_walk(name):
    sd = mesh_sd() if name == "mesh" else tscenes.get(name)
    bake, cam = ct.bake_scene(sd.scene), sd.camera
    counts = {}
    out = ct.trace_pixels_reference(bake, cam, 27, 48, 0, 512, 91, 4,
                                    counts=counts)
    again = ct.trace_pixels_reference(bake, cam, 27, 48, 0, 512, 91, 4)
    assert out.shape == (512, 3) and torch.isfinite(out).all()
    assert torch.equal(out, again) and float(out.mean()) > 0.05
    live = counts["live"]
    assert live >= 512 and counts["cont"] < live
    assert 0 < counts["tri_nodes"] <= live * len(bake.tri_nodes)
    # a tested leaf counts exactly its real rows (pads never hit)
    tests = counts["tri_leaf_tests"].numpy()
    real = bake.tri_leaf_count()
    assert tests.sum() > 0 and (tests[real == 0] == 0).all()
    assert counts["tri_rows"] == int((tests * real).sum())
    assert counts["tri_rows"] <= ct.TRI_LEAF_K * int(tests.sum())
    assert counts["nodes"] == counts["rows"] == 0  # no sphere BVH


def test_regen_matches_jax_golden_statistically(regen_golden):
    g, st, want = regen_golden
    sd = mesh_sd()
    chunk = compile_regen_renderer(sd.scene, sd.camera, st, debug_stats=True,
                                   device="cpu")
    sums, stats = chunk(20241)
    got = sums.numpy()[:st.num_pixels] / st.spp_per_chunk
    assert got.shape == want.shape == (1296, 3) and np.isfinite(got).all()
    z = z_scores(got, want)
    assert (np.abs(z) < Z_LIMIT).all(), z
    assert stats["stream"] == int(g["stream"])
    assert abs(stats["iterations"] / int(g["iterations"]) - 1) < 0.1


def test_wavefront_matches_jax_regen_golden_statistically(regen_golden):
    g, st, want = regen_golden
    sd = mesh_sd()
    chunk = compile_wavefront_renderer(sd.scene, sd.camera, st, device="cpu")
    assert chunk.engine_name == "wavefront"
    sums = chunk(7)
    assert tuple(sums.shape) == (2048, 3)  # npix_pad: two waves of 1,024
    got = sums.numpy()[:st.num_pixels] / st.spp_per_chunk
    assert np.isfinite(got).all() and float(got.min()) >= 0.0
    z = z_scores(got, want)
    assert (np.abs(z) < Z_LIMIT).all(), z


def test_wavefront_is_deterministic_and_refuses_media():
    st = RenderSettings(image_width=16, aspect_ratio=16 / 9,
                        spp_per_chunk=2, num_chunks=1, max_depth=4,
                        ray_batch=64)
    sd = mesh_sd()
    chunk = compile_wavefront_renderer(sd.scene, sd.camera, st, device="cpu")
    a, b, c = chunk(5), chunk(5), chunk(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    smoke = tscenes.get("cornell_smoke")
    with pytest.raises(ValueError, match="no media"):
        compile_wavefront_renderer(smoke.scene, smoke.camera, st,
                                   device="cpu")


def test_wavefront_debug_stats_count_bounces():
    """With `debug_stats` the wavefront chunk returns the same sums and the
    bounces it traced: at least one and at most max_depth a wave."""
    st = RenderSettings(image_width=16, aspect_ratio=16 / 9,
                        spp_per_chunk=2, num_chunks=1, max_depth=4,
                        ray_batch=64)
    sd = mesh_sd()
    sums = compile_wavefront_renderer(sd.scene, sd.camera, st,
                                      device="cpu")(5)
    got, stats = compile_wavefront_renderer(sd.scene, sd.camera, st,
                                            debug_stats=True,
                                            device="cpu")(5)
    waves = st.spp_per_chunk * -(-st.num_pixels // st.ray_batch)
    assert torch.equal(got, sums)
    assert waves < stats["iterations"] <= waves * st.max_depth


@pytest.mark.parametrize("name,args,engine", [
    ("triangles", ["--spp", "2", "--depth", "4"], "megakernel"),
    ("backpack", ["--spp", "4", "--depth", "4", "--ray-batch", "1024"],
     "wavefront")])
def test_cli_renders_triangle_scenes(tmp_path, capsys, name, args, engine):
    out = tmp_path / f"{name}.png"
    assert cli.main(["render", name, "--device", "cpu", "--width", "32",
                     "--chunks", "1", *args, "-o", str(out)]) == 0
    assert f"render engine: {engine} on cpu" in capsys.readouterr().err
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
