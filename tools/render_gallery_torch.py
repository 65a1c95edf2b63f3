#!/usr/bin/env python3
"""Render the scene registry at quality settings with the PyTorch + CUDA
port -> renders_torch/ (counterpart of `tools/render_gallery.py`).

    python3 tools/render_gallery_torch.py              # every scene, PLAN
    python3 tools/render_gallery_torch.py cornell_box door
    python3 tools/render_gallery_torch.py --spp 16 --chunks 1   # quick pass
    python3 tools/render_gallery_torch.py --device cpu --width 16 --spp 1 \\
        --chunks 1 --depth 4 cornell_box triangles     # plain versions

Every registered scene at its `PLAN` width, spp and the reference depth 50,
with russian roulette from bounce 4, through the port's `render()` in waves
of 65,536 rays, as the JAX tool renders it.  Each scene prints one JSON
line: its size, spp and depth, the engine `render()` took
(`compile_renderer`'s `engine_name`, read from the `PhaseTimer` that
`render()` fills), the seconds of the `render()` call (the scene's bake
included), Mrays/s over them, the regen route's host steps, the hand
kernels' launches by C entry (`ops.cuda_trace.launch_counts`) and, on a
card, the peak of allocated device memory in MiB; the image goes to
`<out>/<scene>.png`.  A run of the whole PLAN with no override also writes
`<out>/README.md`, a table of those numbers under the card's name and power
limit.  `--spp`, `--chunks`, `--width` and `--depth` override PLAN for
quick passes.  `--device` defaults to `cuda`, and without a CUDA device the
tool exits with an error; `--device cpu` runs the kernels' plain versions.

door, backpack and cup are the same 100,352-triangle UV sphere at three
scales (`models.scenes._standin_mesh`) when the reference assets are
absent, so each scene bakes its own BVH: the builds differ in their
coordinates.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# scene -> (width, spp_per_chunk, chunks, depth, reference image or None),
# the JAX tool's PLAN (`tools/render_gallery.py:25-42`)
PLAN = {
    "basic": (800, 25, 4, 50, "image5.75.png"),
    "first": (800, 25, 4, 50, "image6.png"),
    "big_scene1": (800, 25, 4, 50, "image7.png"),
    "two_spheres": (800, 25, 4, 50, "image8.png"),
    "two_perlin_spheres": (800, 25, 4, 50, "image9.png"),
    "earth": (800, 25, 4, 50, "image10.75.png"),
    "cornell_box": (512, 50, 4, 50, "image11.png"),
    "cornell_smoke": (512, 50, 4, 50, "image12.png"),
    "triangle": (800, 25, 4, 50, "image13.png"),
    "triangles": (800, 25, 4, 50, "image14.png"),
    "door": (512, 25, 4, 50, "image16.png"),
    # backpack/cup: the procedural 100k-triangle stand-in meshes, with no
    # published image to compare against
    "backpack": (800, 25, 4, 50, None),
    "cup": (800, 25, 4, 50, None),
}
RAY_BATCH = 65536
RR_START = 4

HEADER = """# Rendered gallery of the PyTorch + CUDA port

Every registered scene, rendered by `raytracing_gpu_tpu_torch` on one
{card} (torch {torch}; `python3 tools/render_gallery_torch.py`: russian
roulette from bounce {rr}, the reference depth 50, waves of {batch} rays).
The seconds are one `render()` call's, its scene bake included.  Without
the reference assets `earth` is a solid sphere and door, backpack and cup
are 100,352-triangle UV-sphere stand-ins.  The right column names the
reference's published render of the same scene.

| scene | size | spp | depth | engine | seconds | Mrays/s | render | reference |
|---|---|---|---|---|---|---|---|---|
"""


def render_scene(sd, settings, device) -> tuple:
    """`render()` of the scene definition `sd` at `settings` (its own
    aspect) on `device`, the launch counts (and on a card the peak of
    allocated device memory) set to 0 just before: (image, its line's
    fields).  `steps` is the regen route's host steps (None on the
    megakernel route)."""
    import torch

    from raytracing_gpu_tpu_torch import render
    from raytracing_gpu_tpu_torch.ops import cuda_trace
    from raytracing_gpu_tpu_torch.utils.profiling import PhaseTimer

    st = settings.with_(aspect_ratio=sd.aspect)
    cuda = torch.device(device).type == "cuda"
    timer = PhaseTimer()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cuda_trace.reset_launch_counts()
    t0 = time.perf_counter()
    img = render(sd.scene, sd.camera, st, device=device, timer=timer)
    seconds = time.perf_counter() - t0
    rays = st.num_pixels * st.rays_per_pixel
    return img, dict(
        size=f"{st.image_width}x{st.image_height}", spp=st.rays_per_pixel,
        depth=st.max_depth, rr_start=st.rr_start, engine=timer.engine,
        seconds=seconds, mrays_per_s=rays / seconds / 1e6, steps=timer.steps,
        launches={k: v for k, v in cuda_trace.launch_counts().items() if v},
        peak_mib=(torch.cuda.max_memory_allocated(device) / 2**20
                  if cuda else None))


def main(argv=None) -> list:
    """Render the scenes; returns their lines."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scenes", nargs="*", help="scenes of PLAN (default all)")
    ap.add_argument("--spp", type=int, default=None,
                    help="override spp_per_chunk (quick pass)")
    ap.add_argument("--chunks", type=int, default=None,
                    help="override the number of chunks")
    ap.add_argument("--width", type=int, default=None,
                    help="override the image width")
    ap.add_argument("--depth", type=int, default=None,
                    help="override the depth")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(ROOT, "renders_torch"))
    args = ap.parse_args(argv)
    unknown = [n for n in args.scenes if n not in PLAN]
    if unknown:
        ap.error(f"not in PLAN: {unknown}; choose from {list(PLAN)}")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    device = torch.device(args.device)
    if device.type not in ("cuda", "cpu"):
        ap.error(f"unsupported device {args.device!r}: use cuda or cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to render "
                 "with the plain PyTorch versions")

    from raytracing_gpu_tpu_torch import RenderSettings
    from raytracing_gpu_tpu_torch.engine import film
    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.utils.profiling import card_line

    os.makedirs(args.out, exist_ok=True)
    lines, rows = [], []
    for name in args.scenes or list(PLAN):
        width, spp, chunks, depth, ref = PLAN[name]
        st = RenderSettings(image_width=args.width or width,
                            spp_per_chunk=args.spp or spp,
                            num_chunks=args.chunks or chunks,
                            max_depth=args.depth or depth,
                            ray_batch=RAY_BATCH, rr_start=RR_START)
        img, fields = render_scene(scenes.get(name), st, device)
        line = dict(scene=name, **fields,
                    png=os.path.join(args.out, f"{name}.png"))
        film.write_png(line["png"], img)
        print(json.dumps(line), flush=True)
        lines.append(line)
        ref_cell = f"`{ref}`" if ref else "stand-in mesh (no asset)"
        rows.append(f"| {name} | {line['size']} | {line['spp']} | "
                    f"{line['depth']} | {line['engine']} | "
                    f"{line['seconds']} | {line['mrays_per_s']} | "
                    f"![{name}]({name}.png) | {ref_cell} |\n")

    overrides = (args.spp, args.chunks, args.width, args.depth)
    if not args.scenes and all(v is None for v in overrides):
        card = (card_line() or torch.cuda.get_device_name(device)
                if device.type == "cuda" else "CPU (the plain versions)")
        with open(os.path.join(args.out, "README.md"), "w") as f:
            f.write(HEADER.format(card=card, torch=torch.__version__,
                                  rr=RR_START, batch=RAY_BATCH))
            f.writelines(rows)
    return lines


if __name__ == "__main__":
    main()
