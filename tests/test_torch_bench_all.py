"""`bench_all_torch.py`, the port's `bench_all.py`, on the CPU.

The script itself needs a card; here its planning is held to
`bench_all.py`'s own functions, run with their renderer, scene and timer
replaced by stand-ins (nothing is rendered): for every config the same
settings (chunking, spp, depth, ray batch, russian roulette) and a row
with the same keys and values but the measured ones.  Without a card the
script exits non-zero and prints no row.  The scaling and shard-overhead
rows run on a spawned world of 2 gloo ranks at a small shape, with the keys
of `bench_all.py`'s rows.
"""

import os
import subprocess
import sys
import types

import jax.numpy as jnp
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_all  # noqa: E402
import bench_all_torch as bat  # noqa: E402

MEASURED = {"seconds", "mrays_per_s", "engine"}


@pytest.fixture
def jax_rows(monkeypatch):
    """`bench_all.py`'s workload functions with stand-ins for what they
    render and time; each returns (row, the settings it built)."""
    import raytracing_gpu_tpu.engine.diff as jdiff
    import raytracing_gpu_tpu.engine.render as jrender
    import raytracing_gpu_tpu.models.scenes as jscenes

    seen = {}

    def fake_compile(scene, camera, st, *a, **k):
        seen["st"] = st

        def chunk(*args):
            p = args[0] if len(args) == 2 else None
            if isinstance(p, dict):
                return p["tex_c1"].sum() * p["atlas_data"].sum() * jnp.ones(
                    (4, 3))
            return jnp.zeros((4, 3))

        chunk.engine_name = "stand-in"
        return chunk

    monkeypatch.setattr(jrender, "compile_renderer", fake_compile)
    monkeypatch.setattr(jrender, "compile_param_renderer", fake_compile)
    monkeypatch.setattr(jscenes, "get", lambda name: types.SimpleNamespace(
        scene=None, camera=None))
    monkeypatch.setattr(jdiff, "get_params", lambda scene: {
        "tex_c1": jnp.ones(3), "tex_c2": jnp.ones(3),
        "atlas_data": jnp.ones(3)})
    monkeypatch.setattr(bench_all, "_time_program", lambda *a: 2.0)

    def run(fn, *args):
        row = fn(*args)
        return row, seen["st"]

    return run


def _same_row(mine: dict, theirs: dict):
    assert set(mine) == set(theirs)
    for k in set(theirs) - MEASURED:
        assert mine[k] == theirs[k], k


@pytest.mark.parametrize("spp_scale", [1, 8])
@pytest.mark.parametrize("key", list(bat.FORWARD))
def test_forward_plan_equals_bench_all(jax_rows, key, spp_scale):
    name, width, aspect, spp, depth, batch, rr = bat.FORWARD[key]
    want, jst = jax_rows(bench_all.bench_forward, name, width, aspect, spp,
                         depth, spp_scale, batch, rr)
    st = bat.forward_settings(width, aspect, spp, depth, spp_scale, batch,
                              rr)
    for f in ("image_width", "image_height", "spp_per_chunk", "num_chunks",
              "max_depth", "ray_batch", "rr_start"):
        assert getattr(st, f) == getattr(jst, f), f
    _same_row(bat.forward_row(name, st, spp, 2.0, "regen"), want)


@pytest.mark.parametrize("spp_scale", [1, 4, 16])
def test_train_plan_equals_bench_all(jax_rows, spp_scale):
    want, jst = jax_rows(bench_all.bench_fwd_bwd, spp_scale)
    st = bat.train_settings(spp_scale)
    for f in ("image_width", "image_height", "spp_per_chunk", "num_chunks",
              "max_depth", "ray_batch"):
        assert getattr(st, f) == getattr(jst, f), f
    _same_row(bat.train_row(st, 2.0), want)


@pytest.mark.parametrize("which", ["earth", "mesh"])
def test_grad_plans_equal_bench_all(jax_rows, which):
    fn = (bench_all.bench_earth_grad if which == "earth"
          else bench_all.bench_mesh_grad)
    want, jst = jax_rows(fn, 1)
    st = bat.grad_settings(which)
    for f in ("image_width", "image_height", "spp_per_chunk", "num_chunks",
              "max_depth", "ray_batch"):
        assert getattr(st, f) == getattr(jst, f), f
    _same_row(bat.grad_row(which, st, 2.0, "wavefront-record"), want)


def test_configs_and_the_card_check():
    assert bat.parse_configs("1,2,3,4,5") == ["1", "2", "3", "4", "5",
                                              "5-rr"]
    assert bat.parse_configs("5") == ["5", "5-rr"]
    with pytest.raises(ValueError, match="config"):
        bat.parse_configs("6")
    proc = subprocess.run([sys.executable, os.path.join(ROOT,
                                                        "bench_all_torch.py"),
                           "--configs", "1"], capture_output=True, text=True,
                          timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert proc.stdout == ""
    help_text = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_all_torch.py"), "--help"],
        capture_output=True, text=True, timeout=120).stdout
    assert "A10" not in help_text
    assert all(f in help_text for f in ("--scaling", "--weak", "--cpu-mesh"))


# the scaling rows' workloads, cut to a size the CPU renders in a second
SMALL = dict(bat.SCALING, width=32, ray_batch=256)
SMALL_TINY = dict(bat.TINY, width=32, ray_batch=256)


@pytest.fixture
def jax_shard_rows(monkeypatch):
    """`bench_all.py`'s scaling and shard-overhead rows, with a stand-in
    for the chunk and its timer (its psum loops run on the 8 virtual
    devices)."""
    import raytracing_gpu_tpu.parallel.render as jprender

    def fake_compile(scene, camera, st, mesh, *a, **k):
        return lambda key: jnp.zeros((4, 3))

    monkeypatch.setattr(jprender, "compile_sharded_renderer", fake_compile)
    monkeypatch.setattr(bench_all, "_time_chunks", lambda *a: 2.0)
    return bench_all.bench_scaling(dps=(1, 2)), bench_all.bench_shard_overhead()


def test_scaling_rows_on_a_2_rank_cpu_mesh(jax_shard_rows):
    from raytracing_gpu_tpu_torch.parallel import dryrun

    rows = dryrun.spawn(2, "bench_all_torch:scaling_rank",
                        {"scaling": SMALL, "tiny": SMALL_TINY},
                        deadline=120.0)[0]
    scaling, overhead = jax_shard_rows
    want = {row["mode"]: set(row) | {"config", "shared_card"}
            for row in scaling + overhead}
    assert [(r["mode"], r.get("devices")) for r in rows] == [
        ("scaling", 1), ("scaling", 2), ("psum-cost", None),
        ("tiny-workload-overhead", 1), ("tiny-workload-overhead", 2)]
    for row in rows:
        assert set(row) == want[row["mode"]], row
        assert row["backend"] == "gloo" and row["shared_card"] is False
    assert rows[0]["efficiency"] == 1.0
    assert rows[2]["mesh"] == "(sp=2,dp=1)"
    assert rows[2]["array"] == overhead[0]["array"]
    assert all(r["mrays_per_s"] > 0 for r in rows[:2])
    assert all(r["ms_per_chunk"] > 0 for r in rows[3:])
