"""Time the port's kernels at their main shapes, on one CUDA card.

    python tools/time_kernels.py [--tree DIR] [--sets chunks,train,bvh]

Imports `raytracing_gpu_tpu_torch`, `chip_smoke` and `bench_torch` from the
checkout at DIR (default: this one), so that two checkouts (say a commit
and its parent, unpacked with `git archive`) can be timed in turns on one
card in one sitting: run it once per checkout and compare.  Each run
builds that checkout's kernels (forced, so nvcc's ptxas report of
registers and spills is printed), then times each wave as chip_smoke
does, with CUDA events around 50 launches queued behind a
`torch.cuda._sleep` (`event_ms`).

The set "chunks": one whole chunk of the megakernel route each for
Cornell (512x512, 16 spp, depth 8), config 1 (`first`, 400x225, 16 spp,
depth 8), config 4 (`cornell_smoke`, 512x512, 32 spp, depth 16),
big_scene1 (800x450, 8 spp, depth 16) and `triangles` (400x225, 16 spp,
depth 8), waves of 65,536 rays: the per-wave launches (`Tracer.bind`, one a
(sample, wave), device held), and the route's chunk (`compile_renderer`:
a checkout whose route launches once a chunk runs its chunk launch, an
older one its per-wave loop with the slice-adds), device held and as a
call (host and device).

The set "train": one whole training chunk each of the record kernel for
Cornell (512x512, 8 spp, depth 8, waves of 32,768), big_scene1 (800x450,
16 spp, depth 16, waves of 32,768) and `triangles` (400x225, 8 spp,
depth 8, waves of 65,536): the per-wave launches (`Tracer.bind_record`,
device held), and, in a checkout that has it, the record chunk launch
(`Tracer.bind_record_chunk`, device held); then a whole chunk of config
5's frame (backpack, 800x600, 4 spp, depth 16, waves of 65,536) through
the forward chunk launch and its per-wave launches, the triangle walk of
both, and its centre wave alone (as the set "bvh" times it).

The set "bound": the bound of the "train" set's backpack chunk
(`chip_smoke.backpack_chunk_bound`: the plain walk's work on every 7th of
the chunk's 32 waves, scaled to the chunk).

The set "profile": `bench_torch.py`'s training render (Cornell, 8 chunks
of 8 spp) and one chunk of big_scene1's (800x450, 16 spp, depth 16), each
forward plus backward: its wall time on the host clock and, from a
profiled repeat (`chip_smoke.device_busy`), its device time and the four
kernels that take the most of it.

The set "bvh": `rt_hit` on step 40 of config 5's first
64-spp regen chunk (131,072 rays) and of config 2's (65,536), big_scene1's
training record wave (32,768 rays, depth 16), its ray-plane record wave
(kernel 1c) and its forward megakernel wave (65,536, depth 16), then every
wave of a big_scene1 chunk in turn for those three (ms a chunk), and the
waves that share the node records but not the sphere walk: the backpack's
triangle megakernel wave, `triangles`' record wave, the Cornell forward
and record waves, `first` and `cornell_smoke`.  Prints one JSON line:
{"tree", "card", "ms": {wave: ms}, "registers": [ptxas lines]}.  Uses only
the port's public entry points and `chip_smoke.py`'s helpers, so an older
checkout with the image-texture slice can be timed too.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


# chip_smoke.py's phase 38 shapes, here so that a checkout older than them
# is timed at the same shapes
TRAIN_CHUNKS = (("Cornell", "cornell_box", 512, 8, 8, 32768),
                ("big_scene1", "big_scene1", 800, 16, 16, 32768),
                ("triangles", "triangles", 400, 8, 8, 65536))
BACKPACK_CHUNK = (800, 4, 16, 65536)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--sets", default="chunks,train,bvh",
                    help="comma-separated: chunks, train, bound, profile, "
                         "bvh")
    args = ap.parse_args()
    sets = set(args.sets.split(","))
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    import bench_torch
    import chip_smoke as cs
    from raytracing_gpu_tpu_torch import RenderSettings, compile_renderer
    from raytracing_gpu_tpu_torch.engine import render
    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.ops import build, cuda_trace

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    assert os.path.dirname(os.path.abspath(build.__file__)).startswith(tree)
    # ptxas' report: each entry's name, then its registers and spills
    lines = [ln.strip() for ln in build.build(force=True).log.splitlines()
             if "Compiling entry function" in ln or "Used" in ln
             or "stack frame" in ln]
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    ms = {}

    def time(name, fn):
        ms[name] = cs.event_ms(fn, reps=50, hold_device=True)

    base = 414133122
    if "chunks" in sets:
        for label, name, width, spp, depth in (
                ("Cornell", "cornell_box", 512, 16, 8),
                ("config 1", "first", 400, 16, 8),
                ("config 4", "cornell_smoke", 512, 32, 16),
                ("big_scene1", "big_scene1", 800, 8, 16),
                ("triangles", "triangles", 400, 16, 8)):
            sd = scenes.get(name)
            st = RenderSettings(image_width=width, aspect_ratio=sd.aspect,
                                spp_per_chunk=spp, num_chunks=1,
                                max_depth=depth, ray_batch=65536)
            h, n = st.image_height, 65536
            tracer = cuda_trace.Tracer(sd.scene, dev)
            wave = tracer.bind(sd.camera, h, width, depth)
            nb = -(-h * width // n)
            waves = [lambda r, s=s, b=b: wave(
                b * n, n, cuda_trace.wave_seed(base + r, s, b))
                for s in range(spp) for b in range(nb)]
            ms[f"{label} chunk, {len(waves)} per-wave launches"] = sum(
                cs.event_ms(lambda r, g=waves[k:k + 44]: [f(r) for f in g],
                            reps=2, hold_device=True)
                for k in range(0, len(waves), 44))
            # one call behind the hold: a per-wave route's chunk enqueues
            # a launch and a slice-add a wave
            chunk = compile_renderer(sd.scene, sd.camera, st, dev)
            ms[f"{label} chunk, the route's chunk"] = cs.event_ms(
                lambda r: chunk(base + r), reps=1, hold_device=True)
            ms[f"{label} chunk, the route's chunk as a call"] = cs.event_ms(
                lambda r: chunk(base + r), reps=5)
    if "train" in sets:
        for label, name, width, spp, depth, batch in TRAIN_CHUNKS:
            sd = scenes.get(name)
            h = int(width / sd.aspect)
            tracer = cuda_trace.Tracer(sd.scene, dev)
            wave = tracer.bind_record(sd.camera, h, width, depth)
            nb = -(-h * width // batch)
            waves = [lambda r, s=s, b=b: wave(
                b * batch, batch, cuda_trace.wave_seed(base + r, s, b))
                for s in range(spp) for b in range(nb)]
            ms[f"{label} training chunk, {len(waves)} per-wave record "
               "launches"] = cs.held_ms(waves)
            if hasattr(tracer, "bind_record_chunk"):
                launch = tracer.bind_record_chunk(sd.camera, h, width, depth,
                                                  0.001, batch, spp)
                ms[f"{label} training chunk, the record chunk launch"] = \
                    cs.event_ms(lambda r: launch(base + r), reps=3,
                                hold_device=True)
            del tracer, wave, waves
        sd = scenes.get("backpack")
        width, spp, depth, batch = BACKPACK_CHUNK
        h = int(width / cs.CONFIG5_ASPECT)
        tracer = cuda_trace.Tracer(sd.scene, dev)
        wave = tracer.bind(sd.camera, h, width, depth)
        nb = -(-h * width // batch)
        ms[f"backpack chunk, {spp * nb} per-wave launches"] = cs.held_ms(
            [lambda r, s=s, b=b: wave(b * batch, batch,
                                      cuda_trace.wave_seed(base + r, s, b))
             for s in range(spp) for b in range(nb)])
        launch = tracer.bind_chunk(sd.camera, h, width, depth, 0.001, 0,
                                   batch, spp)
        ms["backpack chunk, the chunk launch"] = cs.event_ms(
            lambda r: launch(base + r), reps=3, hold_device=True)
        time("1d-t backpack forward centre wave, 65536 rays, depth 16",
             lambda r: wave(65536 * cs.MESH_WAVE, 65536,
                            cuda_trace.wave_seed(base, r, 1)))
    if "bound" in sets:
        from raytracing_gpu_tpu_torch.utils import roofline

        # the rates every bound divides by, as chip_smoke.py's phase 4
        cs.Ceilings.flops = max(roofline.fma_ceiling(dev)["flops_per_s"],
                                roofline.card_peaks(dev)["flops_per_s"])
        cs.Ceilings.bytes_per_s = max(
            roofline.hbm_ceiling(dev)["bytes_per_s"],
            roofline.card_peaks(dev)["bytes_per_s"])
        ms["backpack chunk, bound"] = cs.backpack_chunk_bound(
            card, base)["backpack_chunk_bound_ms"]
    if "profile" in sets:
        import time as clock

        from raytracing_gpu_tpu_torch.engine import diff, fused_diff

        for label, name, width, spp, chunks, depth, batch in (
                ("Cornell", "cornell_box", 512, 8, 8, 8, 32768),
                ("big_scene1", "big_scene1", 800, 16, 1, 16, 32768)):
            sd = scenes.get(name)
            st = RenderSettings(image_width=width, aspect_ratio=sd.aspect,
                                spp_per_chunk=spp, num_chunks=chunks,
                                max_depth=depth, ray_batch=batch)
            chunk = fused_diff.compile_fused_param_renderer(
                sd.scene, sd.camera, st, device=dev)
            params = diff.get_params(sd.scene, dev)
            gen = torch.Generator().manual_seed(bench_torch.SEED)
            bases = [cuda_trace.chunk_seed(gen) for _ in range(chunks)]
            target = torch.zeros_like(chunk(params, bases[0]))

            def train(chunk=chunk, params=params, target=target,
                      bases=bases):
                return bench_torch.train_renders(chunk, params, target,
                                                 bases)

            train()  # warm-up
            torch.cuda.synchronize()
            t0 = clock.perf_counter()
            train()
            torch.cuda.synchronize()
            wall = (clock.perf_counter() - t0) * 1e3
            prof = cs.device_busy(train)
            what = f"{label} training, {chunks} x {spp} spp fwd+bwd"
            ms[f"{what}, wall"] = wall
            ms[f"{what}, device (profiled)"] = prof["device_ms"]
            for k, (t, _) in sorted(prof["by_kernel"].items(),
                                    key=lambda kv: -kv[1][0])[:4]:
                ms[f"{what}, device in {k[:48]}"] = t
            del chunk, target
    if "bvh" not in sets:
        print(json.dumps({"tree": tree, "card": card, "ms": ms,
                          "registers": lines}))
        return 0
    # rt_hit on config 5's and config 2's regen steps
    psd, bsd = scenes.get("backpack"), scenes.get("big_scene1")
    width, spp, _, depth = cs.CONFIG5
    c5 = RenderSettings(image_width=width, aspect_ratio=cs.CONFIG5_ASPECT,
                        spp_per_chunk=spp, num_chunks=1, max_depth=depth,
                        ray_batch=cs.CONFIG5_RAY_BATCH)
    rays5, _, _ = cs.capture_step(psd, c5, dev, cs.render_bases(
        c5.with_(num_chunks=cs.CONFIG5[2]))[:1])
    ptr = cuda_trace.Tracer(psd.scene, dev)
    hit5 = ptr.bind_hit()
    time("rt_hit config 5 step 40, 131072 rays", lambda r: hit5(*rays5))
    width, spp, _, depth = cs.CONFIG2
    c2 = RenderSettings(image_width=width, aspect_ratio=bsd.aspect,
                        spp_per_chunk=spp, num_chunks=1, max_depth=depth,
                        ray_batch=65536)
    rays2, _, _ = cs.capture_step(bsd, c2, dev, [base])
    btr = cuda_trace.Tracer(bsd.scene, dev)
    hit2 = btr.bind_hit()
    time("rt_hit config 2 step 40, 65536 rays", lambda r: hit2(*rays2))

    # big_scene1's sphere-BVH waves
    width, spp, chunks, depth, batch = cs.BIG_TRAIN
    bst = RenderSettings(image_width=width, aspect_ratio=bsd.aspect,
                         spp_per_chunk=spp, num_chunks=chunks,
                         max_depth=depth, ray_batch=batch)
    gen = torch.Generator().manual_seed(bench_torch.SEED)
    bbase = cuda_trace.chunk_seed(gen)
    wave = btr.bind_record(bsd.camera, bst.image_height, width, depth,
                           bst.t_min)
    wseed = cuda_trace.wave_seed(bbase, 0, 1)
    time("1b big_scene1 training wave, 32768 rays, depth 16",
         lambda r: wave(batch, batch, wseed + r))
    o, d, tm, rseed = render.wave_rays(bsd.camera.to(dev), bst, 0, batch,
                                       cuda_trace.wave_seed(bbase, 0, 0), dev)
    walk = btr.bind_walk_packed(depth, bst.t_min)
    time("1c big_scene1 first wave, 32768 rays, depth 16",
         lambda r: walk(o, d, tm, rseed + r))

    def forward(tracer, sd, h, w, n, depth, wave_id, name):
        pix = n * wave_id if h * w > n * wave_id else 0
        launch = tracer.bind(sd.camera, h, w, depth)
        time(name, lambda r: launch(pix, n, cuda_trace.wave_seed(base, r, 1)))

    forward(btr, bsd, 450, 800, 65536, 16, 1,
            "1d-s big_scene1 forward wave, 65536 rays, depth 16")

    # every wave of a big_scene1 chunk, each launched as the main path
    # launches them (the single waves above lie in the image's upper rows,
    # mostly sky): ms a chunk, summed over groups of waves few enough for
    # the host to enqueue while the device is held
    def chunk(name, launches, group=44):
        ms[name] = sum(
            cs.event_ms(lambda r, g=launches[k:k + group]: [f(r) for f in g],
                        reps=2, hold_device=True)
            for k in range(0, len(launches), group))

    hw = bst.image_height * width
    waves = [(s, b, b * batch) for s in range(spp)
             for b in range(-(-hw // batch))]
    chunk("1b big_scene1 training chunk, 176 waves of 32768 rays, depth 16",
          [lambda r, s=s, b=b, pix=pix: wave(
              pix, min(batch, hw - pix),
              cuda_trace.wave_seed(bbase, s, b) + r)
           for s, b, pix in waves])
    planes = [render.wave_rays(bsd.camera.to(dev), bst, pix, batch,
                               cuda_trace.wave_seed(bbase, s, b), dev)
              for s, b, pix in waves]
    chunk("1c big_scene1 ray-plane chunk, 176 waves of 32768 rays, depth 16",
          [lambda r, p=p: walk(p[0], p[1], p[2], p[3] + r) for p in planes])
    mega = btr.bind(bsd.camera, 450, 800, 16)
    chunk("1d-s big_scene1 megakernel render, 8 spp x 6 waves, depth 16",
          [lambda r, s=s, pix=pix: mega(pix, min(65536, hw - pix),
                                        cuda_trace.wave_seed(base, s, 1) + r)
           for s in range(8) for pix in range(0, hw, 65536)])
    forward(ptr, psd, 600, 800, 65536, 16, cs.MESH_WAVE,
            "1d-t backpack forward centre wave, 65536 rays, depth 16")
    tsd = scenes.get("triangles")
    ttr = cuda_trace.Tracer(tsd.scene, dev)
    twave = ttr.bind_record(tsd.camera, 225, 400, 8)
    time("1d-t triangles record wave, 65536 rays, depth 8",
         lambda r: twave(0, 65536, cuda_trace.wave_seed(base, r, 1)))
    csd = scenes.get("cornell_box")
    ctr = cuda_trace.Tracer(csd.scene, dev)
    forward(ctr, csd, 512, 512, 65536, 8, 1,
            "1a Cornell forward wave, 65536 rays, depth 8")
    cwave = ctr.bind_record(csd.camera, 512, 512, 8)
    time("1b Cornell record wave, 32768 rays, depth 8",
         lambda r: cwave(32768, 32768, cuda_trace.wave_seed(base, r, 1)))
    for name, width, depth in (("first", 400, 8), ("cornell_smoke", 512, 16)):
        sd = scenes.get(name)
        h = int(width / sd.aspect)
        forward(cuda_trace.Tracer(sd.scene, dev), sd, h, width, 65536, depth,
                1, f"1a {name} forward wave, 65536 rays, depth {depth}")
    print(json.dumps({"tree": tree, "card": card, "ms": ms,
                      "registers": lines}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
