"""The rank side of tests/test_torch_parallel.py: one world of 4 gloo
ranks on the CPU runs every sharded case, at the (sp=2, dp=2) and (1, 4)
meshes, and returns what it rendered; the test process compares.

The unsharded references are split over the ranks and the test process:
each rank computes its share after the cases, with no collective (the
single-process chunk, run by a process that happens to be in a group),
so that the world takes about as long as its slowest rank.
Imports torch and the port, never JAX.
"""

import torch
import torch.distributed as dist

from raytracing_gpu_tpu_torch import RenderSettings
from raytracing_gpu_tpu_torch.engine import diff, render
from raytracing_gpu_tpu_torch.engine.fused_diff import \
    compile_fused_param_renderer
from raytracing_gpu_tpu_torch.engine.wavefront import (
    compile_regen_renderer, compile_wavefront_renderer)
from raytracing_gpu_tpu_torch.models import probes, scenes
from raytracing_gpu_tpu_torch.ops import cuda_trace
from raytracing_gpu_tpu_torch.parallel import distributed, dryrun
from raytracing_gpu_tpu_torch.parallel.mesh import make_mesh
from raytracing_gpu_tpu_torch.parallel.render import (
    compile_sharded_renderer, make_sharded_chunk_fn, render_chunk_sharded)

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# the xla route on `basic` (tests/test_parallel.py:23-26): (mesh, spp)
XLA_CASES = (("1x4", 4), ("2x2", 8), ("2x2", 4))
XLA_BASE = 1234
ROUTE_BASE = 99
DOOR_BASE = 9
FUSED_SETTINGS = dict(image_width=24, aspect_ratio=1.0, spp_per_chunk=2,
                      num_chunks=1, max_depth=3, ray_batch=576)
EARTH_MAP = (32, 64, 7)   # the record-walk route's synthetic map


def xla_settings(spp: int) -> RenderSettings:
    return RenderSettings(image_width=64,
                          aspect_ratio=scenes.get("basic").aspect,
                          spp_per_chunk=spp, num_chunks=1, max_depth=4,
                          ray_batch=512)


def door_settings(kind: str) -> RenderSettings:
    """tests/test_parallel.py's door chunks: the wavefront (64 wide, 4 spp)
    and regen (48 wide, 32 spp) shapes."""
    aspect = scenes.get("door").aspect
    if kind == "wavefront":
        return RenderSettings(image_width=64, aspect_ratio=aspect,
                              spp_per_chunk=4, num_chunks=1, max_depth=4,
                              ray_batch=512, rr_start=2)
    return RenderSettings(image_width=48, aspect_ratio=aspect,
                          spp_per_chunk=32, num_chunks=1, max_depth=4,
                          ray_batch=1024, rr_start=2)


def linear_settings() -> RenderSettings:
    """tests/mh_worker.py's render: basic, 64x64, 4 spp, depth 4."""
    return RenderSettings(image_width=64, aspect_ratio=1.0, spp_per_chunk=4,
                          num_chunks=1, max_depth=4, ray_batch=512)


def earth():
    return scenes.earth(probes.synthetic_image(*EARTH_MAP))


def earth_settings() -> RenderSettings:
    return RenderSettings(image_width=32, aspect_ratio=earth().aspect,
                          spp_per_chunk=2, num_chunks=1, max_depth=3,
                          ray_batch=256)


def fused_run(chunk, params: dict, base: int, npix: int) -> dict:
    """The chunk's primal on the image and the gradients of its L2 loss
    against a zero target."""
    loss, grads = diff.value_and_grad(params, lambda p: chunk(p, base)[:npix],
                                      torch.zeros(npix, 3))
    return dict(primal=chunk(params, base)[:npix].detach(), loss=loss,
                grads=grads)


def run_cases(device: torch.device, fused_base: int) -> dict:
    """Every case on this rank, then this rank's share of the references
    (after the cases, so that no rank waits at a collective for them)."""
    out = cases(device, fused_base)
    out.update(references(dist.get_rank(), device, fused_base))
    return out


def cases(device: torch.device, fused_base: int) -> dict:
    meshes = {k: make_mesh(*v) for k, v in MESHES.items()}
    out = {"mesh": {k: [m.ranks.tolist(), m.sp, m.dp]
                    for k, m in meshes.items()},
           "slice": [distributed.local_chunk_slice(10).start,
                     distributed.local_chunk_slice(10).stop]}
    basic = scenes.get("basic")
    for name, spp in XLA_CASES:
        span = render_chunk_sharded(basic.scene, basic.camera,
                                    xla_settings(spp), XLA_BASE, meshes[name],
                                    device=device)
        out[f"xla_{name}_{spp}"] = meshes[name].gather_dp(span)

    # the kernel routes on ray planes: megakernel (kernel 1c forward) and
    # record-walk (kernel 1c record + the torch shade)
    c = compile_sharded_renderer(basic.scene, basic.camera, xla_settings(4),
                                 meshes["2x2"], device=device)
    out["megakernel"] = (c.engine_name,
                         meshes["2x2"].gather_dp(c(ROUTE_BASE)))
    e = earth()
    c = compile_sharded_renderer(e.scene, e.camera, earth_settings(),
                                 meshes["1x4"], device=device)
    out["record_walk"] = (c.engine_name,
                          meshes["1x4"].gather_dp(c(ROUTE_BASE)))

    door = scenes.get("door")
    tracer = cuda_trace.Tracer(door.scene, device)
    for kind in ("wavefront", "regen"):
        for name, mesh in meshes.items():
            c = compile_sharded_renderer(door.scene, door.camera,
                                         door_settings(kind), mesh,
                                         engine="pallas", device=device,
                                         tracer=tracer)
            out[f"{kind}_{name}"] = (c.engine_name,
                                     mesh.gather_dp(c(DOOR_BASE)))

    cornell = scenes.get("cornell_box")
    fst = RenderSettings(**FUSED_SETTINGS)
    params = diff.get_params(cornell.scene, device)
    for name, mesh in meshes.items():
        for gen_rays in (True, False):
            chunk = compile_fused_param_renderer(
                cornell.scene, cornell.camera, fst, gen_rays=gen_rays,
                device=device, mesh=mesh)
            out[f"fused_{name}_{gen_rays}"] = fused_run(
                chunk, params, fused_base, fst.num_pixels)

    out["linear"] = torch.from_numpy(render.render_linear(
        basic.scene, basic.camera, linear_settings(), seed=3, device=device,
        chunk_fn=make_sharded_chunk_fn(meshes["2x2"], device=device)))
    out["train_step"] = dryrun.train_step_rank(device)
    return out


def references(rank: int, device: torch.device, fused_base: int) -> dict:
    """The unsharded chunks that rank `rank` computes, a share of about a
    second each: no collective.  The door chunks, the longest, are the
    test process's (`door_references`)."""
    basic = scenes.get("basic")
    if rank == 0:
        return {f"ref_xla_{spp}": render._xla_renderer(
            basic.scene, basic.camera, xla_settings(spp), device)(XLA_BASE)
            for spp in (4, 8)}
    if rank == 1:
        return {"ref_train_step": dryrun.train_step_reference(2, device)}
    if rank == 2:
        lst = linear_settings()
        xla = render._xla_renderer(basic.scene, basic.camera, lst, device)
        st = xla_settings(4)
        t = cuda_trace.Tracer(basic.scene, device)
        e = earth()
        return {
            "ref_linear": torch.from_numpy(render.render_linear(
                basic.scene, basic.camera, lst, seed=3, device=device,
                chunk_fn=lambda _sc, _cam, _st, base: xla(base))),
            "ref_megakernel": render.chunk_sums(
                basic.scene, basic.camera, st, ROUTE_BASE,
                lambda _sc, o, d, tm, seed: t(o, d, tm, seed, st.max_depth,
                                              st.t_min), device),
            "ref_record_walk": render.chunk_sums(
                e.scene, e.camera, earth_settings(), ROUTE_BASE,
                render.record_walk_trace_fn(
                    e.scene, earth_settings(),
                    cuda_trace.Tracer(e.scene, device), device), device)}
    cornell = scenes.get("cornell_box")
    fst = RenderSettings(**FUSED_SETTINGS)
    params = diff.get_params(cornell.scene, device)
    return {f"ref_fused_{gen_rays}": fused_run(
        compile_fused_param_renderer(cornell.scene, cornell.camera, fst,
                                     gen_rays=gen_rays, device=device),
        params, fused_base, fst.num_pixels) for gen_rays in (True, False)}


def door_references(device: torch.device | str = "cpu") -> dict:
    """The unsharded wavefront and regen chunks of `door`
    (`door_settings`)."""
    door = scenes.get("door")
    tracer = cuda_trace.Tracer(door.scene, device)
    return {kind: compile(door.scene, door.camera, door_settings(kind),
                          tracer=tracer, device=device)(DOOR_BASE)
            for kind, compile in (("wavefront", compile_wavefront_renderer),
                                  ("regen", compile_regen_renderer))}


def sleep(device: torch.device, seconds: float) -> dict:
    """A rank that outlives any short deadline."""
    import time

    time.sleep(seconds)
    return {}


def hang(device: torch.device) -> dict:
    """Rank 0 waits in an all_reduce that rank 1 never joins."""
    import time

    if dist.get_rank() == 0:
        dist.all_reduce(torch.ones(1))
    else:
        time.sleep(600.0)
    return {}


def fail(device: torch.device) -> dict:
    raise RuntimeError("this rank fails on purpose")
