"""The port's forward render path end to end, on the CPU.

`compile_renderer` (plain version under the hood) against the JAX
package's `compile_renderer(engine="pallas")` and against the pinned JAX
golden, the film writers, the CLI, and importing the port without JAX.

Tolerance for the chunk sums (depth 3): >= 99% of pixels within
atol 1e-3 * max and channel means within 1e-3 relative.
"""

import os
import struct
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.engine.render import compile_renderer as jax_compile
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu_torch import RenderSettings, compile_renderer, render
from raytracing_gpu_tpu_torch import cli
from raytracing_gpu_tpu_torch.engine import film
from raytracing_gpu_tpu_torch.models import scenes as tscenes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port", "cornell_32.npz")
PKG = os.path.join(ROOT, "raytracing_gpu_tpu_torch")


def assert_sums_match(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    within = (err <= 1e-3 * np.abs(want).max()).all(-1).mean()
    assert within >= 0.99, within
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=1e-3)


def _settings(**kw):
    base = dict(image_width=32, aspect_ratio=1.0, spp_per_chunk=2,
                num_chunks=1, max_depth=3, ray_batch=65536)
    return RenderSettings(**{**base, **kw})


def test_chunk_matches_jax_compile_renderer():
    jsd, tsd = jscenes.get("cornell_box"), tscenes.get("cornell_box")
    from raytracing_gpu_tpu.core.config import RenderSettings as JSettings

    key = jax.random.PRNGKey(np.random.default_rng(41).integers(0, 2**31))
    jst = JSettings(image_width=32, aspect_ratio=1.0, spp_per_chunk=2,
                    num_chunks=1, max_depth=3, ray_batch=65536)
    want = np.asarray(jax_compile(jsd.scene, jsd.camera, jst,
                                  engine="pallas")(key))
    base = int(pt.chunk_seed(key))
    chunk = compile_renderer(tsd.scene, tsd.camera, _settings(), device="cpu")
    assert chunk.engine_name == "megakernel"
    assert_sums_match(chunk(base).numpy(), want)


def test_chunk_matches_pinned_jax_golden():
    g = np.load(GOLDEN)
    st = _settings(image_width=int(g["image_width"]),
                   spp_per_chunk=int(g["spp_per_chunk"]),
                   max_depth=int(g["max_depth"]),
                   ray_batch=int(g["ray_batch"]), t_min=float(g["t_min"]))
    tsd = tscenes.get("cornell_box")
    got = compile_renderer(tsd.scene, tsd.camera, st, device="cpu")(
        int(g["base"]))
    assert tuple(got.shape) == g["sums"].shape == (1024, 3)
    assert_sums_match(got.numpy(), g["sums"])


@pytest.mark.parametrize("width,ray_batch", [(16, 65536), (20, 64)])
def test_render_is_finite_and_reproducible(width, ray_batch):
    # (20, 64): 400 pixels in 7 waves of 64, the last one past the image
    tsd = tscenes.get("cornell_box")
    st = _settings(image_width=width, spp_per_chunk=1, num_chunks=2,
                   max_depth=2, ray_batch=ray_batch)
    a = render(tsd.scene, tsd.camera, st, device="cpu")
    b = render(tsd.scene, tsd.camera, st, device="cpu")
    assert a.shape == (width, width, 3) and np.isfinite(a).all()
    assert (a >= 0).all() and (a < 1).all() and a.mean() > 0
    np.testing.assert_array_equal(a, b)


def test_rr_start_is_passed_to_the_tracer():
    # cornell_box, 16x16, 8 spp, depth 6: russian roulette from bounce 1
    # changes the paths but keeps the estimate unbiased; the chunk sums'
    # mean stays within 25% (a few hundred paths) and the image finite
    tsd = tscenes.get("cornell_box")
    st = _settings(image_width=16, spp_per_chunk=8, max_depth=6)
    plain = compile_renderer(tsd.scene, tsd.camera, st, device="cpu")(7)
    rr = compile_renderer(tsd.scene, tsd.camera, st.with_(rr_start=1),
                          device="cpu")(7)
    assert torch.isfinite(rr).all() and not torch.equal(rr, plain)
    assert abs(float(rr.mean()) / float(plain.mean()) - 1.0) < 0.25


def _png_header(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    length, kind = struct.unpack(">I4s", data[8:16])
    assert kind == b"IHDR" and length == 13
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    return w, h, depth, color


def test_png_and_ppm_writers(tmp_path):
    img = np.random.default_rng(42).random((5, 7, 3)) * 0.999
    film.write_png(str(tmp_path / "a.png"), img)
    data = (tmp_path / "a.png").read_bytes()
    assert _png_header(data) == (7, 5, 8, 2)
    idat_len = struct.unpack(">I", data[33:37])[0]
    assert data[37:41] == b"IDAT"
    raw = zlib.decompress(data[41:41 + idat_len])
    rows = np.frombuffer(raw, np.uint8).reshape(5, 1 + 7 * 3)
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3),
                                  film.to_uint8(img))
    assert data.endswith(b"IEND\xaeB`\x82")
    film.write_ppm(str(tmp_path / "a.ppm"), img)
    tokens = (tmp_path / "a.ppm").read_text().split()
    assert tokens[:4] == ["P3", "7", "5", "255"]
    assert len(tokens) == 4 + 5 * 7 * 3


def test_cli_list(capsys):
    assert cli.main(["list"]) == 0
    assert capsys.readouterr().out.split() == tscenes.names()
    assert "first" in tscenes.names() and "cornell_smoke" in tscenes.names()


def test_cli_bench_reports_a_rate(capsys):
    import json

    assert cli.main(["bench", "cornell_box", "--device", "cpu", "--width",
                     "16", "--spp", "1", "--depth", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["engine"] == "megakernel" and line["device"] == "cpu"
    assert line["mrays_per_s"] > 0


def test_cli_render_writes_png(tmp_path):
    out = tmp_path / "c.png"
    assert cli.main(["render", "cornell_box", "--device", "cpu", "--width",
                     "16", "--spp", "1", "--chunks", "1", "--depth", "2",
                     "-o", str(out), "--quiet"]) == 0
    data = out.read_bytes()
    assert _png_header(data) == (16, 16, 8, 2)
    assert len(data) > 60


def test_cli_without_cuda_exits_with_an_error(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "cornell_box", "--width", "16", "-o",
                  str(tmp_path / "x.png")])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "x.png").exists()


def test_port_imports_without_jax():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax'):\n"
            "    sys.modules[m] = None\n"
            "import raytracing_gpu_tpu_torch\n"
            "import raytracing_gpu_tpu_torch.cli, raytracing_gpu_tpu_torch.convert\n"
            "import raytracing_gpu_tpu_torch.ops.build\n"
            "import raytracing_gpu_tpu_torch.utils.profiling\n"
            "assert 'raytracing_gpu_tpu.core' not in sys.modules\n")
    env = {**os.environ, "PYTHONPATH": ROOT}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=120)


def test_port_sources_never_import_jax():
    sources = [os.path.join(ROOT, f) for f in ("bench_torch.py",
                                               "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        sources += [os.path.join(dirpath, f) for f in files
                    if f.endswith(".py")]
    for path in sources:
        text = open(path).read()
        for word in ("import jax", "from jax", "import flax",
                     "from flax", "raytracing_gpu_tpu."):
            assert word not in text, (path, word)
