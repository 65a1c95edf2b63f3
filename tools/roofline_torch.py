#!/usr/bin/env python3
"""Speed-of-light measurements of the PyTorch + CUDA port (counterpart of
`tools/roofline.py`).

    python3 tools/roofline_torch.py                 # on the card
    python3 tools/roofline_torch.py --device cpu    # plain versions, tiny

Prints one JSON line per measurement under `tools/roofline.py`'s `measure`
names and keys, so the two outputs line up.  First `device`: the card's
name and power limit as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` prints them.  Then, on the card, its ceilings from
`utils/roofline.py`: `hbm_rw_chain` (a read + write stream), `mxu_bf16_
matmul` (a chain of 4096^3 bf16 `torch.matmul`s, beside the card's dense
bf16 peak) and `vpu_f32_fma_chain` (kernel 3, `rt_fma_chain`).  Then the
six phases of the north-star training step (`bench_north_star_phases`,
:133-243) on the Cornell box: 65,536 camera rays of the first 128 rows of
the 512x512 frame (u, v as :148-152), drawn by `Camera.get_rays` from a
seeded `torch.Generator`, depth 8:

- `walk_forward_kernel`: `Tracer.__call__` on the rays (kernel 1c forward,
  `rt_trace_rays`);
- `walk_record_kernel`: `Tracer.walk_packed` (kernel 1c record,
  `rt_walk_packed`);
- `xla_shade_forward`: `integrator.shade_packed` over those record planes;
- `xla_shade_fwd_bwd`: the L2 loss of that shade and its `tex_c1`
  gradient by autograd;
- `e2e_chunk_fwd_bwd`: one chunk of `compile_param_renderer` at 512x512,
  8 spp, depth 8, `ray_batch` 65,536, forward and backward of the L2 loss
  against zeros; `route` names the route it takes ("record-walk" on the
  Cornell box: kernel 1c's record entry on ray planes, as the JAX
  package's);
- `e2e_chunk_forward`: one chunk of `compile_renderer` at the same
  settings (kernel 1a's chunk launch, `rt_trace_chunk`).

Each phase line has `seconds`, the host wall of one repetition,
synchronized at both ends, from the difference of two repetition counts
(the JAX tool's meaning: the constant cost cancels); `device_seconds`, a
repetition's CUDA kernel time summed by `torch.profiler`
(`utils.profiling.kernel_times`), which drops some kernel events, so the
figure is a lower bound (`device_note` says so; in a process that has
already profiled long runs it drops every event of a window of a few
kernels, so the tool runs in a process of its own); `hand_device_seconds`,
the share of it in the hand-written kernels (`HAND_KERNELS`), with
`hand_events`, the number of their launches the profiler saw in
`profiled_reps` repetitions; `busy`, `device_seconds` over `seconds`; and
`launches`, the launches of each hand kernel in one repetition.  `--device cpu` runs the kernels' plain versions at a tiny
shape, with no ceilings and no device time, for the tests.  The default
device is `cuda`, and without a CUDA device the tool exits with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The north-star shapes (`tools/roofline.py:146-152`, :225-226) and the
# repetition counts whose difference is timed (`loop_scalar`'s 4 and 36,
# the chunks' 1 and 3); the CPU's tiny shape for the tests.
SHAPES = {
    "cuda": dict(n_rays=65536, width=512, depth=8, spp=8, chunks=8,
                 ray_batch=65536, reps=(4, 36), chunk_reps=(1, 3)),
    "cpu": dict(n_rays=256, width=16, depth=3, spp=2, chunks=8,
                ray_batch=256, reps=(2, 6), chunk_reps=(1, 3)),
}
RAY_SEED = 2   # the camera rays' generator (`jax.random.PRNGKey(2)`)
BASE = 414133122  # repetition i takes base seed BASE + i
DEVICE_NOTE = ("torch.profiler drops some kernel events: device_seconds "
               "and busy are lower bounds")
# the __global__ functions of the hand-written kernels (ops/csrc/
# megakernel.cuh, hit.cu), as the profiler names their launches
HAND_KERNELS = ("megakernel_fwd", "megakernel_record", "hit_kernel")


def emit(**kw) -> dict:
    print(json.dumps(kw), flush=True)
    return kw


def _wall(body, reps: int, device) -> float:
    from raytracing_gpu_tpu_torch.utils.profiling import synchronize

    synchronize(device)
    t0 = time.perf_counter()
    for i in range(reps):
        body(i)
    synchronize(device)
    return time.perf_counter() - t0


def per_rep(body, r1: int, r2: int, device) -> float:
    """Host seconds a repetition of `body(i)`: the best of two walls at r2
    repetitions less the best of two at r1, over r2 - r1, after a warm-up
    (`tools/roofline.py:54-57`)."""
    body(0)
    best = [min(_wall(body, r, device) for _ in range(2)) for r in (r1, r2)]
    return (best[1] - best[0]) / (r2 - r1)


def device_seconds(body, reps: int, device) -> dict:
    """A repetition's CUDA kernel seconds over `reps` profiled
    repetitions: all kernels (`device_seconds`), the hand kernels' share
    (`hand_device_seconds`) and the hand-kernel launches the profiler saw
    in all (`hand_events`); {} off the card."""
    from raytracing_gpu_tpu_torch.utils.profiling import kernel_times

    if device.type != "cuda":
        return {}
    times = kernel_times(lambda: [body(i) for i in range(reps)])
    hand = {k: v for k, v in times.items()
            if any(h in k for h in HAND_KERNELS)}
    return dict(device_seconds=sum(t for t, _ in times.values()) / reps,
                hand_device_seconds=sum(t for t, _ in hand.values()) / reps,
                hand_events=sum(n for _, n in hand.values()),
                profiled_reps=reps)


def launches(body, device) -> dict:
    """The hand kernels' launches in one repetition, by C entry."""
    from raytracing_gpu_tpu_torch.ops import cuda_trace
    from raytracing_gpu_tpu_torch.utils.profiling import synchronize

    synchronize(device)
    cuda_trace.reset_launch_counts()
    body(0)
    synchronize(device)
    return {k: v for k, v in cuda_trace.launch_counts().items() if v}


def phase(measure: str, body, reps: tuple, device, rays: int,
          **keys) -> dict:
    """Time `body(i)` (`per_rep`, `device_seconds`, `launches`) and emit
    its line: `keys` first (the JAX tool's `n_rays` or `chunk_rays` and
    `depth`), then seconds, Mrays/s, device seconds (None off the card),
    busy and launches."""
    seconds = per_rep(body, *reps, device)
    dev = device_seconds(body, reps[0], device)
    dev_s = dev.get("device_seconds")
    line = dict(measure=measure, **keys, seconds=seconds,
                mrays_per_s=rays / seconds / 1e6 if seconds > 0 else None,
                device_seconds=dev_s, **{k: v for k, v in dev.items()
                                         if k != "device_seconds"},
                busy=dev_s / seconds if dev_s and seconds > 0 else None,
                launches=launches(body, device))
    if dev:
        line["device_note"] = DEVICE_NOTE
    return emit(**line)


def device_line(device) -> dict:
    import torch

    from raytracing_gpu_tpu_torch.utils.profiling import card_line

    if device.type != "cuda":
        return emit(measure="device", device="cpu", backend="cpu",
                    card=None, torch=torch.__version__)
    return emit(measure="device", device=torch.cuda.get_device_name(device),
                backend="cuda", card=card_line(), torch=torch.__version__,
                cuda=torch.version.cuda)


def ceilings(device) -> list:
    """`hbm_rw_chain`, `mxu_bf16_matmul` and `vpu_f32_fma_chain`
    (`main`'s order in the JAX tool), on the card."""
    from raytracing_gpu_tpu_torch.utils import roofline

    peaks = roofline.card_peaks(device)
    hbm = roofline.hbm_ceiling(device)
    mxu = roofline.mxu_ceiling(device)
    fma = roofline.fma_ceiling(device)
    bf16 = peaks["bf16_flops_per_s"]
    return [
        emit(measure="hbm_rw_chain", gb_per_s=hbm["bytes_per_s"] / 1e9,
             seconds_per_iter=hbm["seconds_per_pass"],
             peak_gb_per_s=peaks["bytes_per_s"] / 1e9),
        emit(measure="mxu_bf16_matmul", tflops=mxu["flops_per_s"] / 1e12,
             seconds_per_iter=mxu["seconds_per_iter"],
             peak_tflops=None if bf16 is None else bf16 / 1e12,
             peak_share=None if bf16 is None else mxu["flops_per_s"] / bf16),
        emit(measure="vpu_f32_fma_chain", tflops=fma["flops_per_s"] / 1e12,
             seconds_per_step=fma["seconds_per_step"],
             peak_tflops=peaks["flops_per_s"] / 1e12)]


def north_star_phases(device, shape: dict) -> list:
    """The six phases A-F of `bench_north_star_phases` on the Cornell box
    at `shape` (one of SHAPES)."""
    import torch

    from raytracing_gpu_tpu_torch import RenderSettings
    from raytracing_gpu_tpu_torch.engine import diff
    from raytracing_gpu_tpu_torch.engine.integrator import shade_packed
    from raytracing_gpu_tpu_torch.engine.render import (
        compile_param_renderer, compile_renderer)
    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    sd = scenes.get("cornell_box")
    n, w, depth = shape["n_rays"], shape["width"], shape["depth"]
    flat = torch.arange(n, dtype=torch.int64, device=device)
    r_pix, c_pix = flat // w, flat % w
    u = (c_pix.to(torch.float32) + 0.5) / (w - 1)
    v = ((w - 1 - r_pix).to(torch.float32) + 0.5) / (w - 1)
    gen = torch.Generator(device=device).manual_seed(RAY_SEED)
    o, d, tm = (x.contiguous() for x in sd.camera.to(device).get_rays(
        gen, u, v))
    tracer = cuda_trace.Tracer(sd.scene, device)
    params = diff.get_params(sd.scene, device)
    reps, ray_keys = shape["reps"], dict(n_rays=n, depth=depth)
    lines = []

    # A: the forward kernel on ray planes (radiance in the kernel)
    lines.append(phase("walk_forward_kernel", lambda i: tracer(
        o, d, tm, BASE + i, max_depth=depth).sum(), reps, device, n,
        **ray_keys))
    # B: the record walk on ray planes (the packed plane out)
    lines.append(phase("walk_record_kernel", lambda i: tracer.walk_packed(
        o, d, tm, BASE + i, max_depth=depth)[0], reps, device, n,
        **ray_keys))

    planes = tracer.walk_packed(o, d, tm, BASE, max_depth=depth)

    def shade(p):
        return shade_packed(sd.scene, p, *planes, need_p=tracer.need_p,
                            need_uv=tracer.need_uv)

    def shade_forward(i):
        with torch.no_grad():
            return shade(params).sum()

    zeros = torch.zeros((n, 3), dtype=torch.float32, device=device)

    def shade_grad(i):
        val, g = diff.value_and_grad(params, shade, zeros)
        return val + g["tex_c1"].sum()

    # C, D: the torch shade (the JAX package's XLA side), then with autograd
    lines.append(phase("xla_shade_forward", shade_forward, reps, device, n,
                       **ray_keys))
    lines.append(phase("xla_shade_fwd_bwd", shade_grad, reps, device, n,
                       **ray_keys))

    # E, F: whole chunks of the bench frame, fwd+bwd and forward alone
    st = RenderSettings(image_width=w, aspect_ratio=1.0,
                        spp_per_chunk=shape["spp"],
                        num_chunks=shape["chunks"], max_depth=depth,
                        ray_batch=shape["ray_batch"])
    chunk_rays = st.num_pixels * st.spp_per_chunk
    chunk_keys = dict(chunk_rays=chunk_rays, depth=depth)
    pchunk = compile_param_renderer(sd.scene, sd.camera, st, device=device)
    target = torch.zeros_like(pchunk(params, BASE))

    def e2e(i):
        val, g = diff.value_and_grad(
            params, lambda p: pchunk(p, BASE + i), target)
        return val + g["tex_c1"].sum()

    lines.append(phase("e2e_chunk_fwd_bwd", e2e, shape["chunk_reps"],
                       device, chunk_rays, **chunk_keys,
                       route=pchunk.engine_name))
    fchunk = compile_renderer(sd.scene, sd.camera, st, device)
    lines.append(phase("e2e_chunk_forward", lambda i: fchunk(BASE + i).sum(),
                       shape["chunk_reps"], device, chunk_rays, **chunk_keys,
                       route=fchunk.engine_name))
    return lines


def main(argv=None) -> list:
    """Print every measurement's line; returns the lines."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions at a "
                         "tiny shape, for the tests)")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    device = torch.device(args.device)
    if device.type not in SHAPES:
        ap.error(f"unsupported device {args.device!r}: use cuda or cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to run the "
                 "plain versions at a tiny shape")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    lines = [device_line(device)]
    if device.type == "cuda":
        lines += ceilings(device)
    lines += north_star_phases(device, SHAPES[device.type])
    return lines


if __name__ == "__main__":
    main()
