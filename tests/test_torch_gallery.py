"""The render gallery (`tools/render_gallery_torch.py`) and the reference
depth 50, on the CPU.

- The gallery's PLAN is the JAX tool's (`tools/render_gallery.py`), and
  at PLAN's settings (depth 50, russian roulette from bounce 4) every
  scene takes the engine the JAX package's `compile_renderer(engine=
  "pallas")` takes: the megakernel for the dense scenes and the small
  meshes, regen for big_scene1 and the 100k-triangle stand-ins.
- The tool at `--device cpu --width 16 --spp 1 --chunks 1 --depth 4`
  writes a valid PNG of the scene's size and one JSON line a scene; the
  engine and regen steps it prints come from the `PhaseTimer` that
  `render()` fills, whose steps equal the regen chunks' `debug_stats`.
- Depth 50 with russian roulette from bounce 4, against the pinned JAX
  goldens (`tools/make_torch_goldens.py`, JAX on the CPU, the Pallas
  kernel in interpret mode): the plain forward chunk of `cornell_smoke`
  (media, the longest paths), `triangles` (the triangle BVH, whose paths
  all end before bounce 4 at this size) and `models.probes.mesh_box` (a
  closed box of triangles: the triangle walk past bounce 4) under
  `chip_smoke.golden_cmp`'s rule (>= 99% of the pixels within atol 1e-3 *
  max, channel means within 3e-3 relative), and the regen chunk of
  big_scene1 statistically (per channel z < 4, its stream equal, its step
  count within 10% of JAX's, as `tests/test_torch_regen.py` holds the
  depth-8 golden): threefry is not reproduced.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.core.config import RenderSettings as JSettings
from raytracing_gpu_tpu.engine.render import compile_renderer as jcompile
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu_torch import RenderSettings, compile_renderer, render
from raytracing_gpu_tpu_torch.engine import film
from raytracing_gpu_tpu_torch.engine.wavefront import compile_regen_renderer
from raytracing_gpu_tpu_torch.core.camera import Camera
from raytracing_gpu_tpu_torch.models import probes
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.scene.builder import SceneBuilder
from raytracing_gpu_tpu_torch.utils.profiling import PhaseTimer
from raytracing_gpu_tpu_torch.ops import cuda_trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_port")
Z_LIMIT = 4.0
GOLDEN_MEAN_TOL = 3e-3
MESHES = ("door", "backpack", "cup")
REGEN_SCENES = ("big_scene1",) + MESHES


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gallery():
    return _tool("render_gallery_torch")


def test_plan_equals_the_jax_tools(gallery):
    assert gallery.PLAN == _tool("render_gallery").PLAN
    assert (gallery.RAY_BATCH, gallery.RR_START) == (65536, 4)


@pytest.mark.parametrize("name", list(_tool("render_gallery_torch").PLAN))
def test_plan_routes_as_jax(gallery, name):
    width, spp, _chunks, depth, _ref = gallery.PLAN[name]
    tsd = tscenes.get(name)
    kw = dict(image_width=16, aspect_ratio=tsd.aspect, spp_per_chunk=spp,
              num_chunks=1, max_depth=depth, ray_batch=gallery.RAY_BATCH,
              rr_start=gallery.RR_START)
    got = compile_renderer(tsd.scene, tsd.camera, RenderSettings(**kw),
                           device="cpu").engine_name
    assert got == ("regen" if name in REGEN_SCENES else "megakernel")
    if name not in MESHES:  # the JAX bake of 100k triangles is slow here
        jsd = jscenes.get(name)
        assert jcompile(jsd.scene, jsd.camera, JSettings(**kw),
                        engine="pallas").engine_name == got


def test_tool_writes_pngs_and_one_line_a_scene(gallery, tmp_path, capsys):
    lines = gallery.main(["--device", "cpu", "--width", "16", "--spp", "1",
                          "--chunks", "1", "--depth", "4", "--out",
                          str(tmp_path), "cornell_box", "triangles"])
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert out == lines and [x["scene"] for x in out] == ["cornell_box",
                                                          "triangles"]
    for line in out:
        sd = tscenes.get(line["scene"])
        h = int(16 / sd.aspect)
        assert line["size"] == f"16x{h}" and line["spp"] == 1
        assert (line["depth"], line["rr_start"]) == (4, 4)
        assert line["engine"] == "megakernel" and line["launches"] == {}
        assert line["steps"] is None and line["peak_mib"] is None
        assert line["seconds"] > 0 and line["mrays_per_s"] > 0
        assert film.read_png(line["png"]).shape == (h, 16, 3)
    # a quick pass writes no README
    assert sorted(os.listdir(tmp_path)) == ["cornell_box.png",
                                            "triangles.png"]


def test_render_reports_its_engine_and_regen_steps():
    # the PhaseTimer render() fills: the route and the regen chunks' host
    # steps, each one rt_hit launch on the card
    sd = tscenes.get("big_scene1")
    st = RenderSettings(image_width=8, aspect_ratio=sd.aspect,
                        spp_per_chunk=16, num_chunks=2, max_depth=8,
                        ray_batch=256, rr_start=4)
    timer = PhaseTimer()
    render(sd.scene, sd.camera, st, device="cpu", timer=timer)
    chunk = compile_regen_renderer(sd.scene, sd.camera, st, debug_stats=True,
                                   device="cpu")
    gen = torch.Generator().manual_seed(st.seed)
    steps = sum(chunk(cuda_trace.chunk_seed(gen))[1]["iterations"]
                for _ in range(st.num_chunks))
    assert timer.engine == "regen" and timer.steps == steps > 0


def test_tool_refuses_a_scene_outside_plan(gallery):
    with pytest.raises(SystemExit):
        gallery.main(["--device", "cpu", "no_such_scene"])


def test_launch_counts_name_every_entry():
    cuda_trace.reset_launch_counts()
    counts = cuda_trace.launch_counts()
    assert set(counts) == {"rt_trace_pixels", "rt_trace_chunk",
                           "rt_walk_packed_pixels", "rt_walk_chunk",
                           "rt_trace_rays", "rt_walk_packed", "rt_hit"}
    assert not any(counts.values())


def _settings(g) -> RenderSettings:
    return RenderSettings(
        image_width=int(g["image_width"]),
        aspect_ratio=float(g["aspect_ratio"]),
        spp_per_chunk=int(g["spp_per_chunk"]), num_chunks=1,
        max_depth=int(g["max_depth"]), ray_batch=int(g["ray_batch"]),
        t_min=float(g["t_min"]), rr_start=int(g["rr_start"]))


def _deep_scene(name: str):
    if name == "mesh_box":
        return tscenes.SceneDef(*probes.mesh_box(SceneBuilder, Camera))
    return tscenes.get(name)


@pytest.mark.parametrize("name", ["cornell_smoke", "triangles", "mesh_box"])
def test_depth50_chunk_matches_pinned_golden(name):
    g = np.load(os.path.join(DATA, f"{name}_d50.npz"))
    st = _settings(g)
    assert (st.max_depth, st.rr_start) == (50, 4)
    assert st.image_height == int(g["image_height"])
    sd = _deep_scene(name)
    chunk = compile_renderer(sd.scene, sd.camera, st, device="cpu")
    assert chunk.engine_name == "megakernel"
    got = chunk(int(g["base"])).numpy().astype(np.float64)
    want = g["sums"].astype(np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    assert (err <= 1e-3 * np.abs(want).max()).all(-1).mean() >= 0.99
    np.testing.assert_allclose(got.mean(0), want.mean(0),
                               rtol=GOLDEN_MEAN_TOL)
    # in the smoke box and the closed triangle box roulette ends paths:
    # the chunk without it differs (every path of this 32x18, 2-spp
    # `triangles` chunk ends before bounce 4, so `mesh_box` holds the
    # triangle walk's roulette)
    norr = compile_renderer(sd.scene, sd.camera, st.with_(rr_start=0),
                            device="cpu")(int(g["base"])).numpy()
    assert np.array_equal(norr, got.astype(np.float32)) == (
        name == "triangles")


def test_depth50_regen_matches_jax_golden_statistically():
    g = np.load(os.path.join(DATA, "big_scene1_regen_d50.npz"))
    st = _settings(g)
    assert (st.max_depth, st.rr_start) == (50, 4)
    sd = tscenes.get("big_scene1")
    chunk = compile_regen_renderer(sd.scene, sd.camera, st, debug_stats=True,
                                   device="cpu")
    sums, stats = chunk(20241)
    got = sums.numpy()[:st.num_pixels] / st.spp_per_chunk
    want = g["sums"][:st.num_pixels] / st.spp_per_chunk
    assert np.isfinite(got).all()
    diff = (got - want).astype(np.float64)
    z = diff.mean(0) / (diff.std(0, ddof=1) / np.sqrt(len(diff)))
    assert (np.abs(z) < Z_LIMIT).all(), z
    assert stats["stream"] == int(g["stream"])
    assert abs(stats["iterations"] / int(g["iterations"]) - 1) < 0.1
