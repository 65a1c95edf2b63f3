#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one CUDA card.

    python3 chip_smoke.py [--png PATH]

Drives the port's two main paths, each with the kernel launch counts set to
0 just before it and read just after: the forward render of the Cornell box
at 512x512, 64 spp, depth 8, through `raytracing_gpu_tpu_torch.render`
(serving), and `bench_torch.py`'s workload, the forward plus backward
render at 512x512, 64 spp as 8 chunks of 8, depth 8, waves of 32,768 rays,
through `engine.fused_diff.compile_fused_param_renderer` (training).  It
checks both kernels on the way.  Phases, each of which raises on failure:

1. environment: a CUDA device is required; prints the card's name and power
   limit (nvidia-smi) and torch's device name;
2. build: compiles the kernels from `raytracing_gpu_tpu_torch/ops/csrc` with
   nvcc for sm_90a, and prints ptxas' registers and spills per kernel;
3. RNG: the device PCG stream (`rt_pcg_uniform`) equals the plain version
   bit for bit over 2**20 lanes x 3 salts;
4. forward kernel against its plain PyTorch version on the card: Cornell
   64x64, 4 spp, at depth 1 (allclose rtol 1e-5, atol 1e-5) and depth 8
   (>= 99% of lanes within atol 1e-3 * max, channel means within 1e-3
   relative), and one wave at the main path's shape (512x512, 65536 rays,
   depth 8) under the depth-8 rule; at every depth >= 99.9% of the values
   must also be bit-exact; times both at that shape with CUDA events;
5. forward kernel against the pinned JAX golden (tests/data/torch_port/
   cornell_32.npz, made by tools/make_torch_goldens.py): one chunk at 32x32,
   2 spp, depth 3, under the depth-8 rule;
6. serving path: `render()` of cornell_box at 512x512, 16 spp x 4 chunks,
   depth 8, ray_batch 65536 (must launch the forward kernel 64 spp x 4
   waves = 256 times and the record kernel never); the image must be finite
   and lit; writes the PNG; a profiled repeat gives the device's busy share;
   then the plain version renders one 16-spp chunk on the card;
7. record kernel against its plain version on the card: Cornell 64x64,
   4 spp, at depth 1 and 8, and one 32,768-ray wave at 512x512, depth 8,
   under the bit rule (bits 16-18 equal everywhere, bits 0-15 equal where
   bit 16 is set) with >= 99.9% of the words equal; times it at that shape
   with CUDA events, and works out both kernels' bounds from the live
   bounces of their main-shape waves;
8. record kernel against the pinned JAX golden (tests/data/torch_port/
   cornell_grad_32.npz): every wave of the 32x32, 2-spp, depth-3 chunk.
   Every lane must agree at bounce 0 and >= 99% of lanes over all bounces
   under the bit rule (CUDA's and XLA's sin/cos differ by an ulp on some
   draws, which can send a grazing ray elsewhere after a bounce);
9. the two modes agree: for one seed at the main shape, `shade_packed` of
   the record plane against the forward kernel's radiance, under the
   depth-8 rule with >= 99.9% bit-exact;
10. the fused chunk on the card against the golden and against the chunk
   over the plain walk on the card: primal under the depth-8 rule,
   gradients of the L2 loss allclose rtol 2e-4, atol 1e-7;
11. training path: `bench_torch.train_renders` for one full 64-spp forward
   plus backward render (must launch the record kernel 8 chunks x 8 spp x
   8 waves = 512 times, planes saved, and the forward kernel never); prints
   Mrays/s, the peak of allocated device memory, and the device's busy
   share from a profiled repeat.

Prints a JSON line of kernels, the card's name and power limit, and as its
last line `{"ok": true, "device": {...}}`.  Exits non-zero, with no result
line, when anything fails, when there is no CUDA device, or when the port's
package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "raytracing_gpu_tpu_torch/ops/csrc/megakernel.cu"
REPLACES = "raytracing_gpu_tpu/ops/pallas_trace.py:1703"
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port", "cornell_32.npz")
GRAD_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port",
                           "cornell_grad_32.npz")
RNG_LANES = 2**20
RNG_SALTS = (0, 1, 7)
RNG_SEED = -1540198401   # negative: exercises the int32 -> uint32 reading
HOLD_CYCLES = 400_000_000  # torch.cuda._sleep: ~200 ms at the H100's clocks
HOLD_MS_FLOOR = 100.0      # the host must enqueue well within the hold
# The parity build (-fmad=false, no fast math, 1/sqrtf) has matched its
# plain version and the JAX golden bit for bit in every run on an H100, so a
# kernel change that rounds differently (contraction, fast sinf/cosf) must
# lower this floor on purpose.
EXACT_FLOOR = 0.999
LANE_FLOOR = 0.99  # record lanes that must agree with the JAX golden

# The least time the card could take for a kernel's work, from the H100
# SXM's published peaks at a 700 W limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float32 operations (add, multiply, divide, sqrt, sin/cos, min/max,
# compare) per ray in csrc/megakernel.cu, counted from its source; the
# integer PCG hashes are left out, so the bound stays a lower bound.
OPS_CAMERA = 23        # camera_ray: two draws, su/sv, origin, direction
OPS_RECT = 14          # one rect test: guard, divide, two lerps, compares
OPS_BOX = 51           # one box slab test: transform, 3 divides, 6 slabs
OPS_SCATTER = 50       # lambertian_bounce: face normal, normalize, draws,
#                        direction, degenerate test, new origin
OPS_FWD_CONT = 3       # megakernel_fwd's throughput multiply per bounce
OPS_FWD_END = 6        # megakernel_fwd's radiance update at the path's end


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def compare(got, want, depth: int) -> dict:
    """The stated tolerances: depth 1 -> allclose(rtol=1e-5, atol=1e-5);
    deeper -> >= 99% of rows within atol 1e-3 * max|want| and every channel
    mean within 1e-3 relative (cosf/sinf may differ by a few ulp between the
    kernel and torch, so a few paths could diverge after a bounce).  At every
    depth, also at least EXACT_FLOOR of the values equal bit for bit."""
    import torch

    got = got.double().cpu()
    want = want.double().cpu()
    err = (got - want).abs()
    scale = float(want.abs().max())
    within = float((err <= 1e-3 * scale).all(dim=-1).double().mean())
    mean_rel = float(((got.mean(0) - want.mean(0)).abs()
                      / want.mean(0).abs().clamp(min=1e-30)).max())
    exact = float((err == 0).double().mean())
    res = dict(max_abs_err=float(err.max()), frac_within=within,
               mean_rel_err=mean_rel, exact_frac=exact)
    if depth <= 1:
        res["ok"] = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
    else:
        res["ok"] = within >= 0.99 and mean_rel <= 1e-3
    res["ok"] = res["ok"] and exact >= EXACT_FLOOR
    return res


def event_ms(fn, reps: int, hold_device: bool = False) -> float:
    """Mean milliseconds per call of `fn`, CUDA events around `reps` calls
    after one warm-up call.

    With `hold_device`, a `torch.cuda._sleep` queued first keeps the card
    busy while the host enqueues all the calls, so the events time the
    device work alone and not the Python loop around it (`fn` must not
    synchronize).  Without it, the time per call is the larger of the
    host's and the device's."""
    import torch

    fn(0)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold_device:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for r in range(reps):
        fn(r + 1)
    enqueue = time.perf_counter() - t0
    stop.record()
    torch.cuda.synchronize()
    total = start.elapsed_time(stop)
    if hold_device and enqueue * 1e3 >= HOLD_MS_FLOOR:
        raise AssertionError(f"host enqueue took {enqueue * 1e3:.1f} ms, "
                             "longer than the device was held")
    return total / reps


def device_busy(fn) -> dict:
    """Profile one call of `fn` with torch.profiler: device time summed by
    kernel name, wall time, and the device's busy share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0.0)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key[:60]] = (us / 1e3, evt.count)
    busy = sum(ms for ms, _ in by_kernel.values())
    return dict(wall_ms=wall * 1e3, device_ms=busy,
                busy_share=busy / (wall * 1e3) if busy else None,
                by_kernel=by_kernel)


def canonical(words):
    """Record words with the mat bits of non-hit entries cleared, as the bit
    rule compares them."""
    import torch

    words = words.detach().cpu().to(torch.int64)
    hit = (words & (1 << 16)) != 0
    return torch.where(hit, words, words & 0x70000)


def record_cmp(got, want) -> dict:
    """The kernel's record planes against its plain version's: the bit rule
    everywhere, and >= EXACT_FLOOR of the words bit-exact."""
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    res = cuda_trace.record_agreement(got, want)
    res["max_abs_err"] = float((canonical(got) - canonical(want)).abs().max())
    res["ok"] = res["bit_rule"] and res["exact_frac"] >= EXACT_FLOOR
    return res


def grad_cmp(got: dict, want: dict) -> dict:
    """Gradients allclose rtol 2e-4, atol 1e-7 (tests/test_fused_diff.py)."""
    import torch

    res = {"ok": True}
    for k, w in want.items():
        g = got[k].detach().double().cpu()
        w = torch.as_tensor(w).double().cpu()
        res[f"{k}_max_abs_err"] = float((g - w).abs().max())
        res["ok"] = res["ok"] and bool(torch.allclose(g, w, rtol=2e-4,
                                                      atol=1e-7))
    return res


def live_counts(plane) -> tuple[int, int]:
    """(live bounces, continued bounces) of a record plane: entries with
    bit 16 or 18 set, and entries with bit 17 set."""
    live = int(((plane & ((1 << 16) | (1 << 18))) != 0).sum())
    cont = int(((plane & (1 << 17)) != 0).sum())
    return live, cont


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(least milliseconds, what bounds it) for `ops` float32 operations
    and `nbytes` bytes moved."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--png", default=os.path.join(ROOT, "build",
                                                  "chip_smoke_cornell_512.png"))
    args = ap.parse_args()

    import torch

    # ---- 1. environment ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs one CUDA device")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[env] nvidia-smi: {card}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device 0: {kind}, count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    sys.path.insert(0, ROOT)
    import numpy as np

    import bench_torch
    from raytracing_gpu_tpu_torch import RenderSettings, compile_renderer, render
    from raytracing_gpu_tpu_torch.engine import diff, film, fused_diff
    from raytracing_gpu_tpu_torch.engine.integrator import shade_packed
    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.ops import build, cuda_trace

    def reset_counts():
        cuda_trace.Tracer.launches = 0
        cuda_trace.Tracer.record_launches = 0

    # ---- 2. build ----
    res = build.build(force=True)
    build.load()
    print(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: {res.seconds:.2f} s "
          f"-> {os.path.relpath(res.library, ROOT)}")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    # ---- 3. RNG ----
    for salt in RNG_SALTS:
        got = cuda_trace.pcg_uniform(RNG_SEED, RNG_LANES, salt, dev).cpu()
        want = cuda_trace.pcg_uniform(RNG_SEED, RNG_LANES, salt, "cpu")
        same = torch.equal(got, want)
        print(f"[rng] seed {RNG_SEED} salt {salt}: {RNG_LANES} lanes "
              f"bit-exact={same}")
        if not same:
            raise AssertionError(f"device RNG differs at salt {salt}: "
                                 f"{int((got != want).sum())} lanes")

    # ---- 4. kernel against its plain version on the card ----
    sd = scenes.get("cornell_box")
    tracer = cuda_trace.Tracer(sd.scene, dev)
    base = 414133122
    for depth in (1, 8):
        got, want = [], []
        for s in range(4):
            seed = cuda_trace.wave_seed(base, s, 0)
            got.append(tracer.trace_pixels(sd.camera, 64, 64, 0, 4096, seed,
                                           max_depth=depth))
            want.append(cuda_trace.trace_pixels_reference(
                tracer.bake, sd.camera, 64, 64, 0, 4096, seed,
                max_depth=depth, device=dev))
        torch.cuda.synchronize()
        cmp = compare(torch.cat(got), torch.cat(want), depth)
        print(f"[kernel-vs-plain] cornell 64x64 4spp depth {depth}: {cmp}")
        if not cmp["ok"]:
            raise AssertionError(f"kernel disagrees with plain at depth {depth}")

    main_n, main_depth = 65536, 8
    seed = cuda_trace.wave_seed(base, 0, 1)
    got = tracer.trace_pixels(sd.camera, 512, 512, main_n, main_n, seed,
                              max_depth=main_depth)
    want = cuda_trace.trace_pixels_reference(
        tracer.bake, sd.camera, 512, 512, main_n, main_n, seed,
        max_depth=main_depth, device=dev)
    main_cmp = compare(got, want, main_depth)
    print(f"[kernel-vs-plain] main shape 512x512 wave of {main_n} depth "
          f"{main_depth}: {main_cmp}")
    if not main_cmp["ok"]:
        raise AssertionError("kernel disagrees with plain at the main shape")
    wave = tracer.bind(sd.camera, 512, 512, main_depth)

    def kernel_wave(r):
        return wave(main_n, main_n, cuda_trace.wave_seed(base, r, 1))

    kernel_ms = event_ms(kernel_wave, reps=50, hold_device=True)
    kernel_loop_ms = event_ms(kernel_wave, reps=50)
    # the plain version synchronizes once a bounce (its all-dead test), so
    # its time per call is host and device together
    plain_ms = event_ms(lambda r: cuda_trace.trace_pixels_reference(
        tracer.bake, sd.camera, 512, 512, main_n, main_n,
        cuda_trace.wave_seed(base, r, 1), max_depth=main_depth, device=dev),
        reps=3)
    print(f"[time] one wave of {main_n} rays, depth {main_depth}: kernel "
          f"{kernel_ms:.4f} ms on the device ({kernel_loop_ms:.4f} ms per "
          f"call in a Python loop), plain {plain_ms:.4f} ms, on {card}")

    # ---- 5. kernel against the JAX golden ----
    g = np.load(GOLDEN)
    gst = RenderSettings(image_width=int(g["image_width"]), aspect_ratio=1.0,
                         spp_per_chunk=int(g["spp_per_chunk"]), num_chunks=1,
                         max_depth=int(g["max_depth"]),
                         ray_batch=int(g["ray_batch"]),
                         t_min=float(g["t_min"]))
    golden_chunk = compile_renderer(sd.scene, sd.camera, gst, dev)
    gcmp = compare(golden_chunk(int(g["base"])),
                   torch.from_numpy(g["sums"]), gst.max_depth)
    print(f"[kernel-vs-jax-golden] cornell 32x32 2spp depth "
          f"{gst.max_depth}: {gcmp}")
    if not gcmp["ok"]:
        raise AssertionError("kernel disagrees with the JAX golden")

    # ---- 6. the main path ----
    st = RenderSettings(image_width=512, aspect_ratio=1.0, spp_per_chunk=16,
                        num_chunks=4, max_depth=8, ray_batch=65536)
    expected = st.spp_per_chunk * st.num_chunks * (st.num_pixels // st.ray_batch)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render(sd.scene, sd.camera, st, device=dev)
    wall = time.perf_counter() - t0
    launches = cuda_trace.Tracer.launches
    stray = cuda_trace.Tracer.record_launches
    rays = st.num_pixels * st.rays_per_pixel
    print(f"[main] render cornell_box 512x512 64spp depth 8: {wall:.3f} s, "
          f"{rays / wall / 1e6:.2f} Mrays/s, launches {launches} "
          f"(expected {expected}), record launches {stray} on {card}")
    if launches != expected or stray != 0:
        raise AssertionError(f"{launches} forward and {stray} record kernel "
                             f"launches, expected {expected} and 0")
    if img.shape != (512, 512, 3) or not np.isfinite(img).all():
        raise AssertionError(f"bad image: shape {img.shape}, "
                             f"finite {np.isfinite(img).all()}")
    if not 0.05 < float(img.mean()) < 0.999:
        raise AssertionError(f"implausible image mean {img.mean()}")
    os.makedirs(os.path.dirname(os.path.abspath(args.png)), exist_ok=True)
    film.write_png(args.png, img)
    print(f"[main] image mean {img.mean():.6f} -> {args.png}")
    prof = device_busy(lambda: render(sd.scene, sd.camera, st, device=dev))
    # the profiler slows the host, not the device: its device time over the
    # counted render's wall is the busy share of that render
    busy = prof["device_ms"] / (wall * 1e3)
    print(f"[main] profiled repeat of the render: {prof}")
    print(f"[main] device busy share of the counted render: {busy:.4f} "
          f"({prof['device_ms']:.3f} ms of device time in {wall * 1e3:.3f} ms)")

    pst = st.with_(num_chunks=1)
    h, w, b = st.image_height, st.image_width, st.ray_batch
    nb = st.num_pixels // b
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(pst.spp_per_chunk):
        for bid in range(nb):
            cuda_trace.trace_pixels_reference(
                tracer.bake, sd.camera, h, w, bid * b, b,
                cuda_trace.wave_seed(base, s, bid), max_depth=pst.max_depth,
                device=dev)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_rays = pst.num_pixels * pst.spp_per_chunk
    print(f"[main] plain version, one 16-spp chunk: {plain_wall:.3f} s, "
          f"{plain_rays / plain_wall / 1e6:.2f} Mrays/s on {card}")

    # ---- 7. record kernel against its plain version on the card ----
    for depth in (1, 8):
        got, want = [], []
        for s in range(4):
            seed = cuda_trace.wave_seed(base, s, 0)
            got.append(tracer.walk_packed_pixels(sd.camera, 64, 64, 0, 4096,
                                                 seed, max_depth=depth))
            want.append(cuda_trace.walk_packed_pixels_reference(
                tracer.bake, sd.camera, 64, 64, 0, 4096, seed,
                max_depth=depth, device=dev))
        torch.cuda.synchronize()
        rcmp = record_cmp(torch.stack(got), torch.stack(want))
        print(f"[record-vs-plain] cornell 64x64 4spp depth {depth}: {rcmp}")
        if not rcmp["ok"]:
            raise AssertionError(f"record kernel disagrees with plain at "
                                 f"depth {depth}")

    rec_n, rec_base = bench_torch.RAY_BATCH, bench_torch.RAY_BATCH
    rec_seed = cuda_trace.wave_seed(base, 0, 1)
    rec_plane = tracer.walk_packed_pixels(sd.camera, 512, 512, rec_base, rec_n,
                                          rec_seed, max_depth=main_depth)
    rec_cmp = record_cmp(rec_plane, cuda_trace.walk_packed_pixels_reference(
        tracer.bake, sd.camera, 512, 512, rec_base, rec_n, rec_seed,
        max_depth=main_depth, device=dev))
    print(f"[record-vs-plain] main shape 512x512 wave of {rec_n} depth "
          f"{main_depth}: {rec_cmp}")
    if not rec_cmp["ok"]:
        raise AssertionError("record kernel disagrees with plain at the main "
                             "shape")
    rec_wave = tracer.bind_record(sd.camera, 512, 512, main_depth)

    def record_wave(r):
        return rec_wave(rec_base, rec_n, cuda_trace.wave_seed(base, r, 1))

    rec_ms = event_ms(record_wave, reps=50, hold_device=True)
    rec_loop_ms = event_ms(record_wave, reps=50)
    rec_plain_ms = event_ms(lambda r: cuda_trace.walk_packed_pixels_reference(
        tracer.bake, sd.camera, 512, 512, rec_base, rec_n,
        cuda_trace.wave_seed(base, r, 1), max_depth=main_depth, device=dev),
        reps=3)
    print(f"[time] record kernel, one wave of {rec_n} rays, depth "
          f"{main_depth}: {rec_ms:.6f} ms on the device ({rec_loop_ms:.6f} ms "
          f"per call in a Python loop), plain {rec_plain_ms:.6f} ms, on {card}")

    # bounds from the live bounces of each kernel's main-shape wave
    table_bytes = 4 * (tracer.rect_table.numel() + tracer.box_table.numel())
    live, cont = live_counts(rec_plane)
    rec_bound_ms, rec_bound_by = bound(
        rec_n * OPS_CAMERA + live * (6 * OPS_RECT + 2 * OPS_BOX + 1)
        + cont * OPS_SCATTER, 4 * main_depth * rec_n + table_bytes)
    print(f"[bound] record wave: {live} live, {cont} continued bounces of "
          f"{rec_n} rays -> {rec_bound_ms:.6f} ms, bound by {rec_bound_by}")
    fwd_live, fwd_cont = live_counts(tracer.walk_packed_pixels(
        sd.camera, 512, 512, main_n, main_n, cuda_trace.wave_seed(base, 0, 1),
        max_depth=main_depth))
    fwd_bound_ms, fwd_bound_by = bound(
        main_n * (OPS_CAMERA + OPS_FWD_END)
        + fwd_live * (6 * OPS_RECT + 2 * OPS_BOX + 1)
        + fwd_cont * (OPS_SCATTER + OPS_FWD_CONT), 12 * main_n + table_bytes)
    print(f"[bound] forward wave: {fwd_live} live, {fwd_cont} continued "
          f"bounces of {main_n} rays -> {fwd_bound_ms:.6f} ms, bound by "
          f"{fwd_bound_by}")

    # ---- 8. record kernel against the JAX golden ----
    gg = np.load(GRAD_GOLDEN)
    gst = RenderSettings(image_width=int(gg["image_width"]), aspect_ratio=1.0,
                         spp_per_chunk=int(gg["spp_per_chunk"]),
                         num_chunks=1, max_depth=int(gg["max_depth"]),
                         ray_batch=int(gg["ray_batch"]),
                         t_min=float(gg["t_min"]))
    gh, gw, gb = gst.image_height, gst.image_width, gst.ray_batch
    gbase = int(gg["base"])
    gwaves = [(s, bid) for s in range(gst.spp_per_chunk)
              for bid in range(gh * gw // gb)]
    got = torch.stack([tracer.walk_packed_pixels(
        sd.camera, gh, gw, bid * gb, gb, cuda_trace.wave_seed(gbase, s, bid),
        max_depth=gst.max_depth, t_min=gst.t_min) for s, bid in gwaves])
    jcmp = cuda_trace.record_agreement(got, gg["planes"])
    print(f"[record-vs-jax-golden] cornell 32x32 2spp depth "
          f"{gst.max_depth}, {len(gwaves)} waves: {jcmp}")
    if not (jcmp["first_bounce"] and jcmp["lane_frac"] >= LANE_FLOOR):
        raise AssertionError("record kernel disagrees with the JAX golden")

    # ---- 9. the two modes agree ----
    params = diff.get_params(sd.scene, dev)
    shaded = shade_packed(sd.scene, params, rec_plane, need_p=False,
                          need_uv=False)
    fwd = tracer.trace_pixels(sd.camera, 512, 512, rec_base, rec_n, rec_seed,
                              max_depth=main_depth)
    mcmp = compare(shaded, fwd, main_depth)
    print(f"[modes] shade_packed(record) vs forward kernel, 512x512 wave of "
          f"{rec_n} depth {main_depth}: {mcmp}")
    if not mcmp["ok"]:
        raise AssertionError("record and forward modes disagree")

    # ---- 10. fused chunk against the golden and the plain walk ----
    want_grads = {k: gg[f"grad_{k}"] for k in diff.PARAM_KEYS}

    def value_and_grad(chunk):
        out = chunk(params, gbase)
        _, grads = diff.value_and_grad(
            params, lambda p: chunk(p, gbase),
            torch.full_like(out, float(gg["target"])))
        return out.detach(), grads

    fused_out, fused_grads = value_and_grad(
        fused_diff.compile_fused_param_renderer(sd.scene, sd.camera, gst,
                                                device=dev))
    plain_out, plain_grads = value_and_grad(fused_diff.fused_chunk_from_walk(
        sd.scene, lambda pb, n, seed: cuda_trace.walk_packed_pixels_reference(
            tracer.bake, sd.camera, gh, gw, pb, n, seed, gst.max_depth,
            gst.t_min, dev), gst, device=dev))
    for what, out, grads in (
            ("jax-golden", torch.from_numpy(gg["primal"]), want_grads),
            ("plain-on-card", plain_out, plain_grads)):
        pcmp = compare(fused_out, out, gst.max_depth)
        gcmp = grad_cmp(fused_grads, grads)
        print(f"[fused-vs-{what}] cornell 32x32 2spp depth {gst.max_depth}: "
              f"primal {pcmp}, gradients {gcmp}")
        if not (pcmp["ok"] and gcmp["ok"]):
            raise AssertionError(f"fused chunk disagrees with the {what}")

    # ---- 11. the training path ----
    tst = bench_torch.settings()
    tchunk = fused_diff.compile_fused_param_renderer(sd.scene, sd.camera, tst,
                                                     device=dev)
    gen = torch.Generator().manual_seed(bench_torch.SEED)
    target = torch.zeros_like(tchunk(params, cuda_trace.chunk_seed(gen)))
    bench_torch.train_renders(tchunk, params, target,
                              [cuda_trace.chunk_seed(gen)])  # warm-up chunk
    tbases = [cuda_trace.chunk_seed(gen) for _ in range(tst.num_chunks)]
    t_expected = (tst.num_chunks * tst.spp_per_chunk
                  * (tst.num_pixels // tst.ray_batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    loss, grads = bench_torch.train_renders(tchunk, params, target, tbases)
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    t_launches = cuda_trace.Tracer.record_launches
    t_stray = cuda_trace.Tracer.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    t_rays = tst.num_pixels * tst.rays_per_pixel
    t_mrays = t_rays / t_wall / 1e6
    print(f"[train] fwd+bwd cornell_box 512x512 64spp depth 8, ray_batch "
          f"{tst.ray_batch}, save_planes {tchunk.save_planes}: {t_wall:.6f} s, "
          f"{t_mrays:.6f} Mrays/s, record launches {t_launches} (expected "
          f"{t_expected}), forward launches {t_stray}, peak allocated "
          f"{peak_mb:.3f} MiB on {card}")
    if t_launches != t_expected or t_stray != 0:
        raise AssertionError(f"{t_launches} record and {t_stray} forward "
                             f"kernel launches, expected {t_expected} and 0")
    if not (bool(torch.isfinite(loss)) and float(loss) > 0.0
            and all(bool(torch.isfinite(g).all()) for g in grads.values())
            and float(grads["tex_c1"].abs().max()) > 0.0):
        raise AssertionError(f"bad loss {float(loss)} or gradients")
    print(f"[train] summed loss {float(loss):.9g}, tex_c1 gradient "
          f"{grads['tex_c1'].cpu().numpy().tolist()}")
    tprof = device_busy(lambda: bench_torch.train_renders(tchunk, params,
                                                          target, tbases))
    t_busy = tprof["device_ms"] / (t_wall * 1e3)
    top = sorted(tprof["by_kernel"].items(), key=lambda kv: -kv[1][0])[:12]
    print(f"[train] profiled repeat: device {tprof['device_ms']:.3f} ms, wall "
          f"{tprof['wall_ms']:.3f} ms; top kernels (ms, count) {top}")
    print(f"[train] device busy share of the counted render: {t_busy:.6f} "
          f"({tprof['device_ms']:.3f} ms of device time in "
          f"{t_wall * 1e3:.3f} ms)")

    print(json.dumps({"kernels": [{
        "name": "megakernel_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": main_cmp["max_abs_err"],
        "frac_within": main_cmp["frac_within"],
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": fwd_bound_ms, "bound_by": fwd_bound_by,
        "library_ms": None,
        "loop_ms": kernel_loop_ms,
        "render_mrays_per_s": rays / wall / 1e6,
        "render_device_busy_share": busy,
        "profiled_render_busy_share": prof["busy_share"],
        "plain_chunk_mrays_per_s": plain_rays / plain_wall / 1e6}, {
        "name": "megakernel_record", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": t_launches,
        "max_abs_err": rec_cmp["max_abs_err"],
        "exact_frac": rec_cmp["exact_frac"],
        "ms": rec_ms, "plain_ms": rec_plain_ms,
        "bound_ms": rec_bound_ms, "bound_by": rec_bound_by,
        "library_ms": None,
        "loop_ms": rec_loop_ms,
        "train_mrays_per_s": t_mrays,
        "train_device_busy_share": t_busy,
        "train_peak_allocated_mib": peak_mb}]}))
    print(card)  # name, power limit: nvidia-smi's own line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
