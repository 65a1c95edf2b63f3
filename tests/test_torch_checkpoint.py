"""Checkpoint and resume of the port's chunked render, on the CPU.

- A render stopped after 1 of 2 chunks and resumed from its checkpoint
  equals the uninterrupted render bit for bit, on the megakernel route's
  plain version (cornell_smoke) and on the xla engine (the `many_media`
  probe, which "auto" sends there), and through the CLI's
  `--checkpoint-dir`.
- A checkpoint of another seed, setting or scene array, of another shape,
  or without a fingerprint is refused, and the render starts afresh.
- `--debug-nans` stops on the first chunk whose sums hold a NaN; without
  it the render runs on.  `utils.profiling.enable_nan_debugging()` does the
  same for every render until it is turned off.
- `utils.profiling.device_trace` writes a Chrome trace of its region, and
  is a no-op without a directory; `--profile-dir` writes
  `render_trace.json` through it.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu_torch import RenderSettings, cli
from raytracing_gpu_tpu_torch.engine import render
from raytracing_gpu_tpu_torch.core.camera import Camera
from raytracing_gpu_tpu_torch.models import probes, scenes
from raytracing_gpu_tpu_torch.scene.builder import SceneBuilder
from raytracing_gpu_tpu_torch.utils import checkpoint as ckpt
from raytracing_gpu_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _settings(**kw):
    base = dict(image_width=16, aspect_ratio=1.0, spp_per_chunk=2,
                num_chunks=2, max_depth=3, ray_batch=128, seed=7)
    return RenderSettings(**{**base, **kw})


class _Stop(Exception):
    pass


def _stop_after_first(c, _n, _dt):
    if c == 1:
        raise _Stop


@pytest.mark.parametrize("name", ["cornell_smoke", "many_media"])
def test_resumed_render_equals_the_uninterrupted_one(tmp_path, name):
    # cornell_smoke on the megakernel route, many_media on the xla engine
    scene, camera = ((scenes.get(name).scene, scenes.get(name).camera)
                     if name == "cornell_smoke"
                     else probes.many_media(SceneBuilder, Camera)[:2])
    st = _settings()
    full = render.render_linear(scene, camera, st, device="cpu")
    with pytest.raises(_Stop):  # stopped once chunk 1 is saved
        render.render_linear(scene, camera, st, device="cpu",
                             checkpoint_dir=str(tmp_path),
                             progress=_stop_after_first)
    state = ckpt.load(str(tmp_path))
    assert state is not None and state[1] == 1
    done = []
    resumed = render.render_linear(
        scene, camera, st, device="cpu", checkpoint_dir=str(tmp_path),
        progress=lambda c, n, dt: done.append(c))
    assert done == [2]  # only the second chunk ran
    assert np.array_equal(resumed, full) and resumed.mean() > 0.0
    assert ckpt.load(str(tmp_path))[1] == 2


def test_cli_resumes_from_its_checkpoint_dir(tmp_path):
    args = ["render", "cornell_box", "--device", "cpu", "--width", "16",
            "--spp", "1", "--chunks", "2", "--depth", "2", "--quiet",
            "--checkpoint-dir", str(tmp_path / "ck")]
    assert cli.main(args + ["-o", str(tmp_path / "a.png")]) == 0
    sums, done = ckpt.load(str(tmp_path / "ck"))
    assert done == 2
    # a finished checkpoint: the same render again runs no chunk
    assert cli.main(args + ["-o", str(tmp_path / "b.png")]) == 0
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png"
                                                 ).read_bytes()
    assert np.array_equal(ckpt.load(str(tmp_path / "ck"))[0], sums)


def test_a_checkpoint_of_another_render_is_refused(tmp_path):
    sd = scenes.get("cornell_box")
    st = _settings()
    fp = ckpt.fingerprint(st, 7, sd.scene)
    shape = (256, 3)
    ckpt.save(str(tmp_path), np.ones(shape, np.float32), 1, fp=fp)
    assert ckpt.load(str(tmp_path), shape, fp)[1] == 1
    # more chunks: the same render, resumed further
    assert ckpt.fingerprint(st.with_(num_chunks=9), 7, sd.scene) == fp
    moved = dataclasses.replace(sd.scene, rects=dataclasses.replace(
        sd.scene.rects, k=sd.scene.rects.k + np.float32(1.0)))
    others = [ckpt.fingerprint(st, 8, sd.scene),
              ckpt.fingerprint(st.with_(max_depth=4), 7, sd.scene),
              ckpt.fingerprint(st, 7, moved)]
    for other in others:
        assert other != fp and ckpt.load(str(tmp_path), shape, other) is None
    assert ckpt.load(str(tmp_path), (128, 3), fp) is None
    ckpt.save(str(tmp_path), np.ones(shape, np.float32), 1)  # no fingerprint
    assert ckpt.load(str(tmp_path), shape, fp) is None
    ckpt.clear(str(tmp_path))
    assert ckpt.load(str(tmp_path)) is None
    assert not os.listdir(tmp_path)
    # a refused checkpoint: the render starts afresh and overwrites it
    ckpt.save(str(tmp_path), np.full(shape, np.nan, np.float32), 1,
              fp=others[0])
    img = render.render_linear(sd.scene, sd.camera, st, device="cpu",
                               checkpoint_dir=str(tmp_path))
    assert np.isfinite(img).all()
    assert ckpt.load(str(tmp_path), shape, fp)[1] == 2


def test_debug_nans_stops_on_the_first_nan_chunk(tmp_path, monkeypatch):
    calls = []

    def compile_nan(scene, camera, settings, device):
        def chunk(base):
            calls.append(base)
            sums = torch.zeros((256, 3))
            sums[3, 1] = float("nan")
            return sums

        chunk.engine_name = "injected"
        return chunk

    monkeypatch.setattr(render, "compile_renderer", compile_nan)
    args = ["render", "cornell_box", "--device", "cpu", "--width", "16",
            "--spp", "1", "--chunks", "3", "--depth", "2", "--quiet",
            "-o", str(tmp_path / "x.png")]
    with pytest.raises(FloatingPointError, match="chunk 1 of 3"):
        cli.main(args + ["--debug-nans"])
    assert len(calls) == 1 and not (tmp_path / "x.png").exists()
    with np.errstate(invalid="ignore"):  # the NaN reaches the PNG
        assert cli.main(args) == 0  # without the flag the render runs on
    assert len(calls) == 4


def test_enable_nan_debugging_checks_every_render(monkeypatch):
    calls = []

    def compile_nan(scene, camera, settings, device):
        def chunk(base):
            calls.append(base)
            return torch.full((256, 3), float("nan"))

        chunk.engine_name = "injected"
        return chunk

    monkeypatch.setattr(render, "compile_renderer", compile_nan)
    sd = scenes.get("cornell_box")
    st = _settings(num_chunks=3)
    try:
        profiling.enable_nan_debugging()
        assert profiling.nan_debugging()
        with pytest.raises(FloatingPointError, match="chunk 1 of 3"):
            render.render_linear(sd.scene, sd.camera, st, device="cpu")
    finally:
        profiling.enable_nan_debugging(False)
    assert len(calls) == 1 and not profiling.nan_debugging()
    out = render.render_linear(sd.scene, sd.camera, st, device="cpu")
    assert len(calls) == 4 and np.isnan(out).all()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(None) as prof:
        assert prof is None
    with profiling.device_trace(str(tmp_path / "t"), "cpu",
                                "x.json") as prof:
        assert prof is not None
        torch.ones(64).cumsum(0)
    trace = json.loads((tmp_path / "t" / "x.json").read_text())
    assert trace["traceEvents"]
    args = ["render", "cornell_box", "--device", "cpu", "--width", "16",
            "--spp", "1", "--chunks", "1", "--depth", "2", "--quiet",
            "--profile-dir", str(tmp_path / "p"), "-o",
            str(tmp_path / "c.png")]
    assert cli.main(args) == 0
    trace = json.loads((tmp_path / "p" / cli.TRACE_NAME).read_text())
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])
