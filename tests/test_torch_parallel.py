"""The port's sharded rendering (`raytracing_gpu_tpu_torch.parallel`) on the
CPU, over `torch.distributed` with gloo.

One world of 4 ranks is spawned for the module (`parallel.dryrun.spawn`;
a hung rendezvous or collective fails its rank after the group's 30-s
timeout, and every rank is killed at the world's deadline;
`tests/torch_parallel_worker.py` is the ranks' side).  It builds the (sp=2, dp=2) and (1, 4) meshes and runs every case
on them; the unsharded references are split over its ranks.  While it
runs, this process computes the JAX package's sharded chunks on its 8
virtual CPU devices and the unsharded chunks of `door`.  Cases and tolerances (tests/test_parallel.py's):

- the xla route on `basic` (64 wide, depth 4, waves of 512) against the
  unsharded chunk: bit for bit under dp alone, rtol 2e-5 / atol 1e-5
  under sp; the megakernel and record-walk routes (kernel 1c's plain
  versions on ray planes) against `render.chunk_sums` over the same
  trace function;
- `door`'s wavefront (64 wide, 4 spp, depth 4, rr_start 2) against
  `compile_wavefront_renderer`, rtol 1e-5 / atol 1e-5; its regen route
  (48 wide, 32 spp, waves of 1,024) against `compile_regen_renderer`
  statistically (each rank has its own stream): mean within 3% + 5e-3,
  correlation > 0.9;
- the fused training chunk of the Cornell box (24x24, 2 spp, depth 3,
  waves of 576), both ray sources: primal rtol 1e-6 / atol 1e-7,
  gradients of an L2 loss within 2e-5 of their scale (a gradient counted
  twice or four times fails);
- `render_linear` over `make_sharded_chunk_fn` against the unsharded xla
  chunk (tests/mh_worker.py's render, seed 3);
- `dryrun`'s training step (`__graft_entry__.dryrun_multichip`'s checks);
- against the JAX package: the mesh layout, `local_chunk_slice`, the
  sharded fused chunk (gen_rays, the base of `pallas_trace.chunk_seed(key)`)
  against JAX's sharded fused chunk on a (2, 4) mesh in interpret mode
  (the port's forward rule of tests/test_torch_diff.py), and the sharded
  xla chunk against JAX's `render_chunk_sharded` on a (2, 2) mesh, per
  channel z < 4 (threefry is not reproduced).
"""

import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from raytracing_gpu_tpu.core.config import RenderSettings as JSettings
from raytracing_gpu_tpu.engine import diff as jdiff
from raytracing_gpu_tpu.engine.fused_diff import (
    compile_fused_param_renderer as jax_fused)
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu.parallel import distributed as jdistributed
from raytracing_gpu_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raytracing_gpu_tpu.parallel.render import \
    render_chunk_sharded as jax_render_chunk_sharded
from raytracing_gpu_tpu_torch.parallel import distributed, dryrun
from raytracing_gpu_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = 30.0   # a hung rendezvous or collective fails in this
DEADLINE = 150.0       # the ranks are killed after this, hung or slow
SHORT_DEADLINE = 5.0   # the world whose rank sleeps
HANG_TIMEOUT = 5.0     # the world whose collective hangs
FUSED_KEY = 11
XLA_KEY = 1
Z_LIMIT = 4.0


@pytest.fixture(scope="module")
def fused_base():
    return int(pt.chunk_seed(jax.random.PRNGKey(FUSED_KEY)))


@pytest.fixture(scope="module")
def worlds(fused_base, tmp_path_factory):
    """The worlds of the module, started together in the background: the
    4-rank world of the cases, a world whose rank outlives its deadline, a
    world whose rank fails, one whose collective hangs, and the CLI on two
    ranks; and, in a thread of this process, the unsharded chunks of
    `door` (torch's eager loops overlap the JAX compiles of
    `jax_fused_ref` and `jax_xla_ref`)."""
    ex = ThreadPoolExecutor(6)
    futures = dict(
        cases=ex.submit(dryrun.spawn, 4, "torch_parallel_worker:run_cases",
                        {"fused_base": fused_base}, deadline=DEADLINE,
                        timeout=GROUP_TIMEOUT),
        door_refs=ex.submit(W.door_references),
        sleep=ex.submit(dryrun.spawn, 1, "torch_parallel_worker:sleep",
                        {"seconds": 600.0}, deadline=SHORT_DEADLINE),
        fail=ex.submit(dryrun.spawn, 2, "torch_parallel_worker:fail",
                       deadline=DEADLINE, timeout=GROUP_TIMEOUT),
        hang=ex.submit(dryrun.spawn, 2, "torch_parallel_worker:hang",
                       deadline=DEADLINE, timeout=HANG_TIMEOUT),
        cli=ex.submit(_cli_world, tmp_path_factory.mktemp("cli")))
    yield futures
    ex.shutdown(wait=True)


def _cli_world(out_dir) -> tuple:
    """`cli render --sharded --n-sp 2` on two processes joined by the
    coordinator flags: (return codes, outputs, files written)."""
    port = str(dryrun.free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "raytracing_gpu_tpu_torch.cli", "render",
         "cornell_box", "--device", "cpu", "--width", "16", "--spp", "2",
         "--chunks", "2", "--depth", "2", "--ray-batch", "128", "--sharded",
         "--n-sp", "2", "--coordinator-address", f"localhost:{port}",
         "--num-processes", "2", "--process-id", str(r), "-o",
         str(out_dir / "c.png")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=DEADLINE)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs, sorted(os.listdir(out_dir))


@pytest.fixture(scope="module")
def jax_fused_ref():
    """JAX's sharded fused chunk on a (2, 4) mesh, gen_rays: the primal
    and the gradients of mean(out ** 2) over the image."""
    sd = jscenes.get("cornell_box")
    st = JSettings(**W.FUSED_SETTINGS)
    key = jax.random.PRNGKey(FUSED_KEY)
    chunk = jax_fused(sd.scene, sd.camera, st, mesh=jax_make_mesh(2, 4),
                      gen_rays=True)
    params = jdiff.get_params(sd.scene)
    npix = st.num_pixels
    grads = jax.grad(lambda p: jnp.mean(chunk(p, key)[:npix] ** 2))(params)
    return dict(primal=np.asarray(chunk(params, key))[:npix],
                grads={k: np.asarray(v) for k, v in grads.items()})


@pytest.fixture(scope="module")
def jax_xla_ref():
    """JAX's `render_chunk_sharded` of `basic` on a (2, 2) mesh, 4 spp."""
    sd = jscenes.get("basic")
    st = JSettings(image_width=64, aspect_ratio=sd.aspect, spp_per_chunk=4,
                   num_chunks=1, max_depth=4, ray_batch=512)
    out = jax_render_chunk_sharded(sd.scene, sd.camera, st,
                                   jax.random.PRNGKey(XLA_KEY),
                                   jax_make_mesh(2, 2))
    return np.asarray(out)[:st.num_pixels]


@pytest.fixture(scope="module")
def door_refs(worlds):
    return worlds["door_refs"].result()


@pytest.fixture(scope="module")
def world(worlds, jax_fused_ref, jax_xla_ref):
    """The 4-rank world's results, after the JAX references (computed
    here while it runs)."""
    return worlds["cases"].result()


@pytest.fixture(scope="module")
def refs(world):
    """The unsharded chunks the ranks computed, by name."""
    return {k: v for out in world for k, v in out.items()
            if k.startswith("ref_")}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("n_sp,n_dp", [(1, None), (2, None), (4, None),
                                       (8, None), (2, 2), (1, 4), (4, 2)])
def test_mesh_layout_matches_jax(worlds, n_sp, n_dp):
    want = np.vectorize(lambda d: d.id)(jax_make_mesh(n_sp, n_dp).devices)
    assert tmesh.layout(range(8), n_sp, n_dp).tolist() == want.tolist()
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.layout(range(8), 3)


def test_single_process_is_a_1x1_mesh():
    distributed.initialize(num_processes=1)
    distributed.initialize()   # nothing set: stays single-process
    assert not torch.distributed.is_initialized()
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"sp": 1, "dp": 1} and (mesh.sp, mesh.dp) == (0, 0)
    x = torch.arange(6.0).reshape(2, 3)
    assert mesh.sum_sp(x) is x and mesh.gather_dp(x) is x
    assert mesh.sum_all(x) is x
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mesh(1, 2)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.make_mesh(2)
    assert distributed.is_coordinator()
    assert distributed.local_chunk_slice(10) == jdistributed.local_chunk_slice(
        10)
    assert distributed.rank_device("cpu") == torch.device("cpu")
    assert distributed.choose_backend("cpu", 4) == "gloo"


def test_routes_on_a_1x1_mesh():
    """`compile_sharded_renderer`'s tags on a world of one process: "auto"
    takes "xla" where no kernel covers the scene, which "pallas" refuses;
    an sp axis that does not divide the chunk's samples is refused."""
    from raytracing_gpu_tpu_torch.core.camera import Camera
    from raytracing_gpu_tpu_torch.engine.render import shard_geometry
    from raytracing_gpu_tpu_torch.models import probes
    from raytracing_gpu_tpu_torch.parallel.render import \
        compile_sharded_renderer
    from raytracing_gpu_tpu_torch.scene.builder import SceneBuilder

    mesh = tmesh.make_mesh()
    media, media_cam, _aspect = probes.many_media(SceneBuilder, Camera)
    basic, earth = W.scenes.get("basic"), W.earth()
    st = W.xla_settings(4)
    for scene, cam, engine, tag in (
            (media, media_cam, "auto", "xla"),
            (basic.scene, basic.camera, "auto", "megakernel"),
            (basic.scene, basic.camera, "xla", "xla"),
            (earth.scene, earth.camera, "auto", "record-walk")):
        chunk = compile_sharded_renderer(scene, cam, st, mesh, engine=engine,
                                         device="cpu")
        assert chunk.engine_name == tag
    with pytest.raises(NotImplementedError):
        compile_sharded_renderer(media, media_cam, st, mesh, engine="pallas",
                                 device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        shard_geometry(W.xla_settings(3),
                       tmesh.Mesh(tmesh.layout(range(2), 2), 0))
    with pytest.raises(ValueError, match="not in the mesh"):
        shard_geometry(st, tmesh.Mesh(tmesh.layout(range(2), 2), 5))


def test_world_meshes_and_slices(world):
    for r, out in enumerate(world):
        for name, (n_sp, n_dp) in W.MESHES.items():
            grid, sp, dp = out["mesh"][name]
            assert grid == tmesh.layout(range(4), n_sp, n_dp).tolist()
            assert (sp, dp) == (r // n_dp, r % n_dp)
        assert out["slice"] == [3 * r, min(3 * r + 3, 10)]


@pytest.mark.parametrize("name,spp", W.XLA_CASES)
def test_xla_chunk_matches_unsharded(world, refs, name, spp):
    npix = W.xla_settings(spp).num_pixels
    want = _np(refs[f"ref_xla_{spp}"])[:npix]
    for out in world:
        got = _np(out[f"xla_{name}_{spp}"])[:npix]
        if name == "1x4":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("route,tag", [("megakernel", "megakernel"),
                                       ("record_walk", "record-walk")])
def test_kernel_routes_match_chunk_sums(world, refs, route, tag):
    st = (W.xla_settings(4) if route == "megakernel"
          else W.earth_settings())
    want = _np(refs[f"ref_{route}"])[:st.num_pixels]
    assert float(want.mean()) > 0.0
    for out in world:
        name, frame = out[route]
        assert name == tag
        got = _np(frame)[:st.num_pixels]
        if route == "record_walk":    # (1, 4): dp alone
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(W.MESHES))
def test_sharded_wavefront_matches_unsharded(world, door_refs, name):
    npix = W.door_settings("wavefront").num_pixels
    want = _np(door_refs["wavefront"])[:npix]
    for out in world:
        tag, frame = out[f"wavefront_{name}"]
        assert tag == "wavefront"
        np.testing.assert_allclose(_np(frame)[:npix], want, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", list(W.MESHES))
def test_sharded_regen_matches_unsharded_statistically(world, door_refs,
                                                       name):
    st = W.door_settings("regen")
    npix = st.num_pixels
    single = _np(door_refs["regen"])[:npix] / st.spp_per_chunk
    for out in world:
        tag, frame = out[f"regen_{name}"]
        assert tag == "regen"
        sh = _np(frame)[:npix] / st.spp_per_chunk
        assert abs(sh.mean() - single.mean()) < 0.03 * single.mean() + 5e-3
        corr = np.corrcoef(sh.reshape(-1), single.reshape(-1))[0, 1]
        assert corr > 0.9, (name, corr)


@pytest.mark.parametrize("gen_rays", [True, False])
@pytest.mark.parametrize("name", list(W.MESHES))
def test_sharded_fused_matches_unsharded(world, refs, name, gen_rays):
    want = refs[f"ref_fused_{gen_rays}"]
    for out in world:
        got = out[f"fused_{name}_{gen_rays}"]
        np.testing.assert_allclose(_np(got["primal"]), _np(want["primal"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-6)
        for k, ga in want["grads"].items():
            ga, gb = _np(ga), _np(got["grads"][k])
            scale = np.abs(ga).max() + 1e-12
            np.testing.assert_allclose(gb, ga, rtol=0, atol=2e-5 * scale,
                                       err_msg=k)
    assert np.abs(_np(want["grads"]["tex_c1"])).max() > 0.0


def test_render_linear_over_the_sharded_chunk(world, refs):
    want = _np(refs["ref_linear"])
    assert want.shape == (64, 64, 3) and want.mean() > 0.0
    for out in world:
        np.testing.assert_allclose(_np(out["linear"]), want, rtol=2e-5,
                                   atol=1e-5)


def test_dryrun_train_step(world, refs):
    report = dryrun.check_train_step([out["train_step"] for out in world],
                                     refs["ref_train_step"])
    assert report["loss"] > 0.0 and report["grad_err"] <= 1e-4


def test_sharded_fused_matches_jax(world, jax_fused_ref):
    """The port's (2, 2) gen_rays chunk against JAX's (2, 4) one, on the
    same base: the forward rule and gradient tolerance of
    tests/test_torch_diff.py (the record planes agree by the bit rule)."""
    got = world[0]["fused_2x2_True"]
    primal = _np(got["primal"]).astype(np.float64)
    want = jax_fused_ref["primal"].astype(np.float64)
    err = np.abs(primal - want)
    assert (err <= 1e-3 * np.abs(want).max()).all(-1).mean() >= 0.99
    np.testing.assert_allclose(primal.mean(0), want.mean(0), rtol=1e-3)
    for k, g in jax_fused_ref["grads"].items():
        np.testing.assert_allclose(_np(got["grads"][k]), g, rtol=2e-4,
                                   atol=1e-7, err_msg=k)


def test_sharded_xla_matches_jax_statistically(world, jax_xla_ref):
    got = _np(world[0]["xla_2x2_4"])[:len(jax_xla_ref)]
    diff = (got - jax_xla_ref).astype(np.float64)
    z = diff.mean(0) / (diff.std(0, ddof=1) / np.sqrt(len(diff)))
    assert (np.abs(z) < Z_LIMIT).all(), z


def test_a_world_past_its_deadline_is_killed(worlds):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="deadline"):
        worlds["sleep"].result(timeout=DEADLINE)
    assert time.monotonic() - t0 < DEADLINE


def test_a_failed_rank_fails_the_world(worlds):
    with pytest.raises(RuntimeError, match="fails on purpose"):
        worlds["fail"].result(timeout=DEADLINE)


def test_a_hung_collective_fails_within_the_group_timeout(worlds):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 0 of 2 failed.*Timed "
                                           "out"):
        worlds["hang"].result(timeout=DEADLINE)
    assert time.monotonic() - t0 < DEADLINE


def test_cli_sharded_on_two_processes(worlds):
    rcs, outs, files = worlds["cli"].result(timeout=DEADLINE)
    assert rcs == [0, 0], outs
    assert files == ["c.png"]
    assert "render engine: megakernel (sharded, sp=2, dp=1)" in outs[0]
    assert "rendered" in outs[0] and "rendered" not in outs[1]
