"""Command-line interface (counterpart of `raytracing_gpu_tpu/cli.py`).

    python -m raytracing_gpu_tpu_torch.cli list
    python -m raytracing_gpu_tpu_torch.cli render cornell_box -o out.png \\
        --width 512 --spp 16 --chunks 4 --depth 8
    python -m raytracing_gpu_tpu_torch.cli bench cornell_box --width 512

`--device` defaults to `cuda`.  Without a CUDA device the CLI exits with an
error unless `--device cpu` is given, which runs the kernels' plain PyTorch
versions on the CPU.  `list` prints the 13 registered scenes, meshes and
image scenes included (`triangle`, `triangles`, `earth`, `door`,
`backpack`, `cup`).  `render` logs the engine it takes ("megakernel",
"regen", "wavefront" or, for an image-textured scene, "record-walk", as
`engine.render.route` picks it, or "xla" for a scene that no kernel
covers) unless `--quiet`.  `--checkpoint-dir` saves the sums after every
chunk and resumes a render stopped there; `--profile-dir` writes a
`torch.profiler` trace of the render; `--debug-nans` stops on the first
chunk whose sums hold a NaN.

`--sharded` splits each chunk over the ranks of a process group, as an
(sp, dp) mesh with `--n-sp` on the sample axis (`parallel/`); the group
comes from `--coordinator-address`, `--num-processes` and `--process-id`
on every process, or from torchrun:

    torchrun --nproc-per-node 2 -m raytracing_gpu_tpu_torch.cli render \
        cornell_box --device cpu --sharded --n-sp 2 --width 64 --spp 4

Every rank renders its share; rank 0 alone logs, saves checkpoints and
writes the image.  `--multihost` is `--sharded` (the JAX package's flag for
a mesh over every host's devices).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

TRACE_NAME = "render_trace.json"  # --profile-dir's trace file


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracing_gpu_tpu_torch",
                                description="PyTorch + CUDA path tracer")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", help="render a registered scene to PNG/PPM")
    r.add_argument("scene", help="scene name (see `list`)")
    r.add_argument("-o", "--output", default="image.png",
                   help="output path (.png or .ppm)")
    r.add_argument("--width", type=int, default=1200)      # render.h:22
    r.add_argument("--spp", type=int, default=100,         # render.h:26
                   help="samples per pixel per chunk")
    r.add_argument("--chunks", type=int, default=10,       # render.h:37 no_fb
                   help="number of sample chunks (frame buffers)")
    r.add_argument("--depth", type=int, default=50)        # render.h:27
    r.add_argument("--ray-batch", type=int, default=65536)
    r.add_argument("--seed", type=int, default=1984)       # render.h:91
    r.add_argument("--rr-start", type=int, default=0,
                   help="russian roulette from this bounce (0 = off)")
    r.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    r.add_argument("--checkpoint-dir", default=None,
                   help="directory for resumable float32 partial sums")
    r.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the render to this "
                        "directory")
    r.add_argument("--debug-nans", action="store_true",
                   help="stop on the first chunk whose sums hold a NaN (one "
                        "host read a chunk)")
    r.add_argument("--sharded", action="store_true",
                   help="shard each chunk over the ranks of the process "
                        "group (an sp x dp mesh); the group comes from the "
                        "--coordinator-* flags or torchrun's environment, "
                        "else the process renders alone")
    r.add_argument("--n-sp", type=int, default=1,
                   help="sample-parallel mesh axis size (with --sharded)")
    r.add_argument("--multihost", action="store_true",
                   help="join the process group (implies --sharded): pass "
                        "the three --coordinator-* flags on every process, "
                        "or start the processes with torchrun")
    r.add_argument("--coordinator-address", default=None,
                   help="host:port of rank 0's rendezvous")
    r.add_argument("--num-processes", type=int, default=None)
    r.add_argument("--process-id", type=int, default=None)
    r.add_argument("--quiet", action="store_true")

    sub.add_parser("list", help="list registered scenes")

    b = sub.add_parser("bench", help="time a forward render and report Mrays/s")
    b.add_argument("scene")
    b.add_argument("--width", type=int, default=512)
    b.add_argument("--spp", type=int, default=16)
    b.add_argument("--depth", type=int, default=8)
    b.add_argument("--ray-batch", type=int, default=65536)
    b.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)

    from .models import scenes

    if args.command == "list":
        for name in scenes.names():
            print(name)
        return 0

    import torch

    device = torch.device(args.device)
    sharded = args.command == "render" and (args.sharded or args.multihost)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device is available; pass --device cpu to "
                     "render with the plain PyTorch version on the CPU")
    if device.type not in ("cuda", "cpu"):
        parser.error(f"unsupported device {args.device!r}: use cuda or cpu")
    if args.scene not in scenes.names():
        parser.error(f"scene {args.scene!r} is not ported; ported scenes: "
                     f"{', '.join(scenes.names())}")

    from .core.config import RenderSettings
    from .engine.render import compile_renderer, render_linear
    from .utils.profiling import PhaseTimer, RaysPerSecond

    sd = scenes.get(args.scene)

    if args.command == "bench":
        st = RenderSettings(image_width=args.width, aspect_ratio=sd.aspect,
                            spp_per_chunk=args.spp, num_chunks=1,
                            max_depth=args.depth, ray_batch=args.ray_batch)
        chunk = compile_renderer(sd.scene, sd.camera, st, device)
        chunk(0)  # builds the kernel library at first use
        meter = RaysPerSecond()
        with meter.measure(st.num_pixels * st.spp_per_chunk, device):
            chunk(1)
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        print(json.dumps({"scene": args.scene, "mrays_per_s": meter.mrays,
                          "seconds": meter.seconds,
                          "engine": chunk.engine_name, "device": name}))
        return 0

    st = RenderSettings(image_width=args.width, aspect_ratio=sd.aspect,
                        spp_per_chunk=args.spp, num_chunks=args.chunks,
                        max_depth=args.depth, ray_batch=args.ray_batch,
                        seed=args.seed, rr_start=args.rr_start)

    from .engine import film
    from .parallel import distributed
    from .utils.profiling import device_trace, logger

    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("%(message)s"))
    level = logger.level
    if not args.quiet:  # render_linear logs the engine it takes
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    try:
        chunk_fn = None
        if sharded:
            distributed.initialize(args.coordinator_address,
                                   args.num_processes, args.process_id,
                                   device=device)
            device = distributed.rank_device(device)
        # every rank renders its share; only the coordinator writes
        # (`cli.py:169-172`)
        is_coord = distributed.is_coordinator()
        if not is_coord:
            logger.removeHandler(handler)
        if sharded:
            chunk_fn = _sharded_chunk_fn(args.n_sp, sd, st, device)

        def progress(c, n, dt):
            if not args.quiet and is_coord:
                rays = st.num_pixels * st.spp_per_chunk
                print(f"chunk {c}/{n}: {dt:.2f}s "
                      f"({rays / dt / 1e6:.2f} Mrays/s)", file=sys.stderr)

        timer = PhaseTimer()
        t0 = time.perf_counter()
        with device_trace(args.profile_dir if is_coord else None, device,
                          TRACE_NAME):
            linear = render_linear(
                sd.scene, sd.camera, st, seed=args.seed, progress=progress,
                device=device, timer=timer,
                checkpoint_dir=args.checkpoint_dir if is_coord else None,
                debug_nans=args.debug_nans, chunk_fn=chunk_fn)
            elapsed = time.perf_counter() - t0  # the trace's export after
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
        if sharded:
            distributed.finalize()
    if not is_coord:
        return 0
    if args.profile_dir and not args.quiet:
        print(f"profile trace -> "
              f"{os.path.join(args.profile_dir, TRACE_NAME)}",
              file=sys.stderr)
    img = film.finalize(linear * st.rays_per_pixel, st.rays_per_pixel)
    if args.output.endswith(".ppm"):
        film.write_ppm(args.output, img)
    else:
        film.write_png(args.output, img)
    if not args.quiet:
        total_rays = st.num_pixels * st.rays_per_pixel
        print(f"rendered {args.scene} {st.image_width}x{st.image_height} "
              f"{st.rays_per_pixel}spp on {device} in {elapsed:.1f}s "
              f"({total_rays / elapsed / 1e6:.2f} Mrays/s) -> {args.output}",
              file=sys.stderr)
        print(timer.report(), file=sys.stderr)
    return 0


def _sharded_chunk_fn(n_sp: int, sd, st, device):
    """`parallel.render.make_sharded_chunk_fn` over an (n_sp, world / n_sp)
    mesh of the process group's ranks, logging its route."""
    from .parallel.mesh import make_mesh
    from .parallel.render import make_sharded_chunk_fn
    from .utils.profiling import logger

    mesh = make_mesh(n_sp=n_sp)
    chunk_fn = make_sharded_chunk_fn(mesh, sd.scene, sd.camera, st,
                                     device=device)
    logger.info("render engine: %s (sharded, sp=%d, dp=%d) on %s",
                chunk_fn.engine_name, mesh.shape["sp"], mesh.shape["dp"],
                device)
    return chunk_fn


if __name__ == "__main__":
    sys.exit(main())
