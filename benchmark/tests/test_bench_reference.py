"""The frozen reference agrees with the port's plain versions at a tiny
size, path for path, and the roofline count does not depend on which of
the two traced the paths."""

import pytest
import torch

from benchmark import cells, check, peaks, program
from benchmark.reference import drive, paths
from raytracing_gpu_tpu_torch.engine import diff
from raytracing_gpu_tpu_torch.engine.fused_diff import (
    compile_fused_param_renderer)
from raytracing_gpu_tpu_torch.models import scenes
from raytracing_gpu_tpu_torch.ops import cuda_trace

CONFIGS = ["cornell_box", "cornell_smoke"]
H = W = 20
SPP, DEPTH, WAVE, BASE = 3, 10, 96, 1_234_567_891


def _parts(name):
    cfg = cells.config(name)
    prog = program.build(cfg)
    sc, cam, geom = check.reference_parts(cfg, H, W, WAVE)
    return cfg, prog, sc, cam, geom


@pytest.mark.parametrize("name", CONFIGS)
def test_scene_equals_the_port_registry(name):
    _, prog, _, _, _ = _parts(name)
    mine = cuda_trace.bake_scene(prog.scene)
    reg = scenes.get(name)
    theirs = cuda_trace.bake_scene(reg.scene)
    for table in ("rect_table", "box_table", "media_table"):
        assert (getattr(mine, table)() == getattr(theirs, table)()).all()
    assert (cuda_trace._cam_tuple(prog.camera, H, W)
            == cuda_trace._cam_tuple(reg.camera, H, W))


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_chunk_bit_for_bit(name):
    _, prog, sc, cam, geom = _parts(name)
    bake = cuda_trace.bake_scene(prog.scene)
    want = cuda_trace.trace_chunk_reference(bake, prog.camera, H, W, BASE,
                                            SPP, WAVE, DEPTH, 0.001)
    got = drive.sample_sums(sc, cam, geom, [BASE], SPP,
                            torch.arange(geom.npix), DEPTH, 0.001)
    assert torch.equal(want[:geom.npix], got)


@pytest.mark.parametrize("name", CONFIGS)
def test_record_walk_bit_for_bit(name):
    _, prog, sc, cam, geom = _parts(name)
    bake = cuda_trace.bake_scene(prog.scene)
    want = cuda_trace.walk_chunk_reference(bake, prog.camera, H, W, BASE,
                                           SPP, WAVE, DEPTH, 0.001)[0]
    got = drive._walk_chunk(sc, cam, geom, BASE, SPP, DEPTH, 0.001, "cpu",
                            torch.float32)
    assert torch.equal(want, got)


@pytest.mark.parametrize("name", CONFIGS)
def test_training_step_matches_the_port(name):
    """Sums and loss bit for bit, the albedo gradient to rounding."""
    cfg, prog, sc, cam, geom = _parts(name)
    st = prog.settings.with_(image_width=W, spp_per_chunk=SPP, num_chunks=1,
                             max_depth=DEPTH, ray_batch=WAVE)
    chunk = compile_fused_param_renderer(prog.scene, prog.camera, st,
                                         device="cpu")
    target = torch.full((geom.npix, 3), 0.25)
    params = {k: v.requires_grad_(True)
              for k, v in diff.get_params(prog.scene, "cpu").items()}
    sums = chunk(params, BASE)
    loss = torch.mean((sums[:geom.npix] / SPP - target) ** 2)
    loss.backward()
    ref = drive.train_steps(sc, cam, geom, torch.as_tensor(sc.albedo),
                            target, [BASE], SPP, 0.01, DEPTH, 0.001)
    assert torch.equal(sums.detach(), ref["sums"])
    assert float(loss) == ref["losses"][0]
    torch.testing.assert_close(params["tex_c1"].grad, ref["grad"],
                               rtol=1e-5, atol=1e-9)
    assert not params["tex_c2"].grad.any()


@pytest.mark.parametrize("name", CONFIGS)
def test_roofline_count_is_the_same_whichever_traced(name):
    _, prog, sc, cam, geom = _parts(name)
    bake = cuda_trace.bake_scene(prog.scene)
    theirs = {}
    cuda_trace.trace_chunk_reference(bake, prog.camera, H, W, BASE, SPP,
                                     WAVE, DEPTH, 0.001, counts=theirs)
    mine = paths.zero_counts()
    drive.sample_sums(sc, cam, geom, [BASE], SPP,
                      torch.arange(geom.rows), DEPTH, 0.001, counts=mine)
    assert mine["live"] == theirs["live"]
    assert mine["cont"] == theirs["cont"]
    kinds = {0: "lambertian", 4: "isotropic"}
    assert {kinds[k]: v for k, v in theirs["scatter"].items()} == {
        k: v for k, v in mine["scatter"].items() if v}
    theirs_counts = dict(paths=mine["paths"], live=theirs["live"],
                         cont=theirs["cont"],
                         scatter={kinds[k]: v
                                  for k, v in theirs["scatter"].items()})
    args = (len(sc.rects), len(sc.boxes), len(sc.media))
    assert (peaks.render_work(*args, mine, 1e9, 10, geom.rows)
            == peaks.render_work(*args, theirs_counts, 1e9, 10, geom.rows))
