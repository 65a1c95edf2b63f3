#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one CUDA card.

    python3 chip_smoke.py [--png PATH]

Drives the port's main paths, each with the kernel launch counts set to 0
just before it and read just after: the forward render of the Cornell box
at 512x512, 64 spp, depth 8, through `raytracing_gpu_tpu_torch.render`
(serving); `bench_torch.py`'s workload, the forward plus backward render at
512x512, 64 spp as 8 chunks of 8, depth 8, waves of 32,768 rays, through
`engine.fused_diff.compile_fused_param_renderer` (training); BASELINE
config 1 (`first`, 400x225, 16 spp, depth 8) and config 4
(`cornell_smoke`, 512x512, 128 spp, depth 16) through `render`; big_scene1
on the megakernel route (800x450, 8 spp, depth 16: the sphere-BVH walk) and
BASELINE config 2 (big_scene1, 800x450, 32 spp as 2 chunks of 16, depth
16) through `render` on the regen route (the hit kernel); BASELINE config
5 (`backpack`, the 100,352-triangle stand-in, 800x600, one of its 4
chunks of 64 spp, depth 16, waves of 131,072 rays) and config 5-rr through
`render` on the regen route (the hit kernel's triangle tier), the same
scene on the wavefront route (8 spp a chunk), and `triangles` on the
megakernel route (its triangle walk); the training path beyond the
Cornell box: big_scene1 (800x450, 32 spp as 2 chunks of 16, depth 16)
forward plus backward through `compile_fused_param_renderer` (the record
kernel with the hit-point planes and the sphere-BVH walk), `triangles` in
training (the triangle-BVH record walk), `compile_param_renderer` on
big_scene1 (the record-walk route: ray planes, kernel 1c) and on backpack
(`bench_all.py`'s mesh-grad row, the wavefront-record route); image
textures, on synthetic maps (the reference assets are not in the
repository): `earth` (800x450, 32 spp as 2 chunks of 16, depth 8) through
`render` on the record-walk route (the record kernel's uv planes on ray
planes, the torch shade), `bench_all.py`'s earth-grad row through
`compile_param_renderer`, and BASELINE config 5 with its diffuse map
(800x600, one chunk of 64 spp, depth 16, regen) and its mesh-grad row;
the reference depth 50 (kernel 1a's and 1d-t's chunk launches, regen,
every gallery scene on its full-size route, the CLI's default render);
`tools/roofline_torch.py` (the north-star phases and the ceilings); and the
ceiling probe whose rates every printed bound divides by.  It checks every
kernel on the way.  Phases, each of which raises on failure:

1. environment: a CUDA device is required; prints the card's name and power
   limit (nvidia-smi) and torch's device name;
2. build: compiles the kernels from `raytracing_gpu_tpu_torch/ops/csrc` with
   nvcc for sm_90a, one process per source, and prints ptxas' registers
   and spills per kernel;
3. RNG: the device PCG stream (`rt_pcg_uniform`) equals the plain version
   bit for bit over 2**20 lanes x 3 salts;
4. ceilings: the FMA-chain kernel (`rt_fma_chain`, kernel 3) against its
   plain version (rtol 1e-5: one rounding a step against two) at chain
   lengths 1, 7, 8, 13 and 21, where the chain has not converged and a
   chain one step short fails that tolerance (the unrolled loop and its
   tail), and at 1,088 steps; then the card's own float32 FMA rate and
   memory read + write rate as measured (`utils/roofline.py`) beside its
   peak rates from its attributes; every bound below divides by the larger
   of the measured and the peak rate;
5. forward kernel against its plain PyTorch version on the card: Cornell
   64x64, 4 spp, at depth 1 (allclose rtol 1e-5, atol 1e-5) and depth 8
   (>= 99% of lanes within atol 1e-3 * max, channel means within 1e-3
   relative), and one wave at the main path's shape (512x512, 65536 rays,
   depth 8) under the depth-8 rule; at every depth >= 99.9% of the values
   must also be bit-exact; times both at that shape with CUDA events;
6. forward kernel against the pinned JAX golden (tests/data/torch_port/
   cornell_32.npz, made by tools/make_torch_goldens.py): one chunk at 32x32,
   2 spp, depth 3, under the depth-8 rule;
7. serving path: `render()` of cornell_box at 512x512, 16 spp x 4 chunks,
   depth 8, ray_batch 65536 (must launch the forward kernel once a chunk,
   4 times through `rt_trace_chunk`, and no other kernel); the image must
   be finite
   and lit; writes the PNG; a profiled repeat gives the device's busy share;
   then the plain version renders one 16-spp chunk on the card;
8. record kernel against its plain version on the card: Cornell 64x64,
   4 spp, at depth 1 and 8, and one 32,768-ray wave at 512x512, depth 8,
   under the bit rule (bits 16-18 equal everywhere, bits 0-15 equal where
   bit 16 is set) with >= 99.9% of the words equal; times it at that shape
   with CUDA events, and works out both kernels' bounds from the live
   bounces of their main-shape waves;
9. record kernel against the pinned JAX golden (tests/data/torch_port/
   cornell_grad_32.npz): every wave of the 32x32, 2-spp, depth-3 chunk.
   Every lane must agree at bounce 0 and >= 99% of lanes over all bounces
   under the bit rule (CUDA's and XLA's sin/cos differ by an ulp on some
   draws, which can send a grazing ray elsewhere after a bounce);
10. the two modes agree: for one seed at the main shape, `shade_packed` of
   the record plane against the forward kernel's radiance, under the
   depth-8 rule with >= 99.9% bit-exact;
11. the fused chunk on the card against the golden and against the chunk
   over the plain walk on the card: primal under the depth-8 rule,
   gradients of the L2 loss allclose rtol 2e-4, atol 1e-7;
12. training path: `bench_torch.train_renders` for one full 64-spp forward
   plus backward render (must launch the record kernel once a chunk, 8
   times through `rt_walk_chunk` for its 8 x 8 x 8 = 512 waves, planes
   saved, and the forward kernel never); prints
   Mrays/s, the peak of allocated device memory, and the device's busy
   share from a profiled repeat;
13. the dense scenes (basic, first, two_spheres, two_perlin_spheres,
   cornell_smoke): the forward kernel against its plain version on the
   card at 64x64, 4 spp, depth 1 and 8 (the rules of phase 5), then
   against each scene's pinned JAX golden (`<scene>_32.npz`: one chunk at
   width 32, 2 spp, depth 3): >= 99% of pixels within atol 1e-3 * max,
   channel means within 3e-3 relative (`golden_cmp`);
14. record mode on first and cornell_smoke: the record kernel against its
   plain version on the card (64x64, 4 spp, depth 8; the bit rule with
   >= 99.9% of the words equal) and against the golden's planes (every lane
   at bounce 0, >= 99% of lanes over all bounces);
15. BASELINE config 1: `render()` of first at 400x225, 16 spp as 1 chunk,
   depth 8, ray_batch 65536 (must launch the forward kernel once, a chunk
   launch, and no other kernel); finite and lit, PNG written,
   Mrays/s and the busy share of a profiled repeat; its main wave (65,536
   rays) held against the plain version on the same seed under phase 5's
   depth-8 rule with >= 99.9% bit-exact, then timed (kernel, loop, plain
   version) beside its bound, counted from the live bounces by material
   kind of a record walk of the same seed;
16. BASELINE config 4: the same for cornell_smoke at 512x512, 128 spp as
   4 chunks x 32, depth 16 (must launch the forward kernel 4 times, once a
   chunk);
17. russian roulette: one 65,536-ray wave of cornell_smoke at 512x512,
   depth 16, rr_start 2, against its plain version under the depth-8 rule
   with >= 99.9% bit-exact (and unlike the wave without it); then
   `render()` at 512x512, 32 spp, depth 16 with rr_start 2 and without,
   one seed: finite, and the means within 5% of each other;
18. big_scene1's kernels: the sphere-BVH forward kernel against its plain
   version (phase 5's rules at 64x64) and against the pinned JAX golden
   (`big_scene1_32.npz`, `golden_cmp`); the hit kernel (`rt_hit`) against
   the pinned Pallas hit golden (`big_scene1_hit.npz`: packed words equal
   on every lane, the float outputs under `cuda_trace.hit_agreement`'s
   rule) and against its plain version on 65,536 camera rays and one
   bounce of them on big_scene1, first and cornell_box (packed words equal
   on every lane, >= 99.9% of the float values bit-exact), then on
   PARTIAL_HIT (65,536 + 37) big_scene1 rays and one bounce of them under
   three lane masks (half dead at random, every other warp dead, one live
   lane in a warp): every output equal on every lane (`hit_every_lane`);
19. big_scene1 on the megakernel route: `render()` at 800x450, 8 spp,
   depth 16 (must launch the forward kernel once, a chunk launch, and the
   hit kernel never), its main wave against the plain version and timed
   beside
   its bound (counted by the plain version: live bounces, scatters by
   material kind, and the BVH walk's node and row tests); then the regen
   and megakernel routes at 400x225, 16 spp, depth 16 agree statistically
   (per channel, the mean per-pixel difference within 4 standard errors);
20. BASELINE config 2: `render()` of big_scene1 at 800x450, 32 spp as 2
   chunks of 16, depth 16, ray_batch 65,536, on the regen route (the hit
   kernel launched once per step, the forward kernel never); Mrays/s,
   steps (one host read each), host time per step and the busy share of a
   profiled repeat; then the 65,536 rays of one steady-state step (step
   CAPTURE_STEP of a chunk) through the hit kernel against its plain
   version, timed beside the bound counted by the plain walk of the same
   rays;
21. the regen chunk on the card against the pinned JAX regen chunk
   (`big_scene1_regen.npz`: 48x27, 16 spp, depth 8) statistically, and its
   step count within 10% of JAX's;
22. the triangle kernels against their plain versions on the card (packed
   words equal on every lane and >= 99.9% of the values bit-exact):
   `rt_hit`'s triangle tier on REDUCED_RAYS camera rays of config 5 and one
   scattered bounce of them (the plain walk over 100k triangles is slow, so
   the wave is reduced), the triangle megakernel on `triangles` at 64x64,
   4 spp, depth 1 and 8 (phase 5's rules), and both against the pinned JAX
   goldens (`mesh_hit.npz` under `hit_agreement`'s rule with triangle ids
   equal but across shared edges; `triangles_32.npz` under `golden_cmp`);
   then `hit_every_lane` on PARTIAL_HIT backpack rays and one bounce of
   them, and on the tie scene (`models.probes.tie_mesh`: one triangle in
   two slots of a leaf, another in leaves of its own), whose triangle
   megakernel's record, ray-plane and forward waves of PARTIAL_WAVE
   (32,768 + 37) lanes equal their plain versions on every lane
   (`waves_every_lane`);
23. config 5's first 64-spp regen chunk (waves of 131,072 rays,
   `bench_all.py:441`) at the seeds `render()` draws, through
   `compile_regen_renderer`'s `debug_stats`: their steps, each with one hit
   launch; then timing at full size with CUDA events: `rt_hit` on the
   131,072 rays of a steady-state step of the first chunk (CAPTURE_STEP)
   and the triangle megakernel's 65,536-ray wave of
   backpack at 800x600, depth 16 (the centre wave, data for re-deriving
   the mesh routing); each held against its plain version on the same
   inputs, timed beside the plain version and the bound counted by the
   plain walk of the same rays (the bytes are the parts of the triangle
   tables that walk reads);
24. BASELINE config 5: `render()` of backpack at 800x600, one of its 4
   chunks of 64 spp (CONFIG5; `bench_all_torch.py` renders all 4), depth
   16, ray_batch 131,072 on the regen route: the hit
   kernel launched as many times as phase 23 counted regen steps, the
   megakernels never; finite and lit, PNG written; Mrays/s, steps, host
   time per step, peak device memory, and the busy share of a bounded
   sub-run (one 16-spp chunk, profiled with CUDA activity only); then
   config 5-rr (`bench_all.py:445-447`: the same with rr_start 2), finite
   and lit, with its Mrays/s and steps;
25. the wavefront route: `render()` of backpack at 800x600, 8 spp, one
   chunk, depth 16 (engine "wavefront", one hit launch per bounce that the
   same chunk's `debug_stats` count), then the wavefront and regen routes
   at 160x120 agree statistically;
26. `triangles` on the megakernel route: `render()` at 400x225, 16 spp,
   depth 8 (the triangle megakernel once, a chunk launch, no hit launch);
27. kernel 1b's hit-point planes and BVH walks against their plain
   versions on the card: the record planes of two_spheres,
   two_perlin_spheres, big_scene1 and triangles at 64x64, 4 spp, depth 8,
   and a reduced wave of backpack (the bit rule with >= 99.9% of the words
   and of the hit-point values equal); then against the pinned Pallas
   record planes (`<scene>_rec32.npz`) under the CPU rules of
   tests/test_torch_record_p.py; then big_scene1's sphere-BVH record,
   ray-plane and forward waves of PARTIAL_WAVE lanes at its training shape
   (800x450, depth 16), every plane equal on every lane;
28. kernel 1c against its plain versions: `walk_packed` and `__call__`
   (with and without russian roulette) on 65,536 torch-drawn camera rays
   of cornell_box and big_scene1, then against the pinned Pallas planes
   and radiance on their stored rays (`<scene>_rays.npz`); a chunk of the
   Cornell box (512x512, 4 spp, depth 8) through `render.chunk_sums` over
   `__call__` (16 ray-plane launches), and its wave timed;
29. the fused chunk with hit points: over the two_spheres golden's own
   planes against the JAX fused chunk's primal and gradients (rtol 2e-4,
   atol 1e-7), and over the kernel's walk against the chunk over the plain
   walk on the card (primal under the depth-8 rule, gradients rtol 2e-4,
   atol 1e-7);
30. config 2's scene in training: `bench_torch.train_renders` over
   `compile_fused_param_renderer` on big_scene1 at 800x450, 2 chunks of
   16 spp, depth 16, waves of 32,768 rays, L2 loss against zeros (the
   record chunk launch once a chunk forward and once backward, planes not
   saved: 4 launches for 2 x 2 x 16 x 11 = 704 waves; no other kernel);
   finite, nonzero tex_c1 and tex_c2 gradients; Mrays/s, peak memory, the
   busy share of a one-chunk sub-run; the training wave held against its
   plain version and timed; then `triangles` in training (400x225, 8 spp,
   depth 8: one record chunk launch for its 16 waves), its wave held and
   timed;
31. the record-walk route: `compile_param_renderer` on big_scene1 at
   800x450, one 16-spp chunk, depth 16 (engine "record-walk", the ray-plane
   record entry 16 x 11 = 176 times), its primal equal to
   `compile_fused_param_renderer(gen_rays=False)`'s on the same base; then
   forward plus backward (176 launches each way, planes not saved), with
   finite, nonzero tex_c1 and tex_c2 gradients and the peak memory; its
   first wave held against its plain version and timed;
32. `bench_all.py`'s mesh-grad row: `compile_param_renderer` on backpack at
   800x600, 4 spp, depth 8, waves of 65,536 rays (engine
   "wavefront-record"), forward plus backward: one hit launch per bounce
   the chunk counts, no megakernel launch, a nonzero tex_c1 gradient;
   seconds and Mrays/s;
33. kernel 1b's uv planes against their plain versions on the card (the
   bit rule and >= 99.9% of the words and of the u, v values bit-exact),
   each wave timed with its bound (4 + 8 bytes an entry): the image probe
   of `models/probes.py` (two images on rects, an image box, a box
   medium, a rotated image sphere, a 1,024-triangle image mesh; 512x512,
   65,536 rays, depth 8), `earth` with a 1024x512 map on camera rays and
   on ray planes (kernel 1c; 65,536 rays, depth 8), 70 image spheres under
   the sphere BVH (800x450, 65,536 rays, depth 16) and the backpack
   stand-in with a 1024x1024 map (a reduced wave of 8,192 rays, depth 16);
   then the probe's and earth's planes against the pinned Pallas planes
   (`image_probe_uv32.npz`, `earth_fused32.npz`) under the CPU rules of
   tests/test_torch_record_uv.py;
34. `earth` through `render()` at 800x450, 2 chunks of 16 spp, depth 8
   (engine "record-walk": the ray-plane record entry 32 x 6 = 192 times,
   no other kernel), a finite image, Mrays/s and the busy share of a
   profiled repeat; the routes of depth 50 (regen) and of russian
   roulette on the image probe (record-walk, with the warning), without
   rendering;
35. `bench_all.py`'s earth-grad row: `compile_param_renderer` on earth at
   256x256, 8 spp, depth 8, waves of 65,536 (record-walk), forward plus
   backward: nonzero atlas_data gradients, Mrays/s, the peak memory, and
   the gradients of the same chunk over the plain record walk on the card
   (rtol 2e-4, atol 1e-7); the image probe's atlas gradients nonzero in
   both of its images;
36. BASELINE config 5 with its map: `render()` of the backpack stand-in
   with a 1024x1024 diffuse map at 800x600, one chunk of 64 spp, depth 16,
   waves of 131,072 (regen: hit launches only, uv from `rt_hit`, the
   image shade in torch), Mrays/s, steps beside phase 24's, the busy
   share of a one-chunk sub-run; then its mesh-grad row (800x600, 4 spp,
   depth 8, wavefront-record) with nonzero atlas_data gradients;
37. whole chunks of the megakernel route: one chunk each of Cornell
   (512x512, 16 spp, depth 8), config 1, config 4 (32 spp, depth 16),
   big_scene1 (800x450, 8 spp, depth 16: the sphere-BVH walk) and
   `triangles` (400x225, 16 spp, depth 8), waves of 65,536 rays: the chunk
   launch, the per-wave launches' sums added in order and the plain
   version on the card equal bit for bit on every row; the chunk launch and
   the per-wave launches timed (device held, and with the host), beside
   the plain chunk and the chunk's bound (its waves' operations, counted by
   the plain version), with the grid the card's occupancy gives;
38. whole training chunks of the record kernel: one chunk each of the
   Cornell training render (512x512, 8 spp, depth 8, waves of 32,768),
   big_scene1's (800x450, 16 spp, depth 16, hit-point planes, the sphere
   BVH) and `triangles`' (400x225, 8 spp, depth 8, the triangle BVH): the
   record chunk launch (`rt_walk_chunk`), the per-wave launches stacked
   and the plain chunk walk on the card equal bit for bit on every plane,
   wave and lane; the chunk launch and the per-wave launches timed (device
   held), beside the plain chunk and the chunk's bound (operations from
   the plain chunk's counts, bytes as the planes written once and the
   tables read once), with the grid and ptxas' registers; then a whole
   chunk of config 5's frame (backpack, 800x600, 4 spp, depth 16, waves of
   65,536) through the forward chunk launch (the triangle walk) against
   its per-wave launches, bit for bit, both timed;
39. the pure-torch "xla" engine as an oracle of the hit kernel:
   `engine.intersect.closest_hit` (its own BVH walk, `accel.traverse`)
   against `rt_hit` resolved to hit records (`wavefront.
   resolve_hit_packed`) on the same camera rays and one scattered bounce
   of them, for config 2 (big_scene1, lens and motion blur, 65,536 rays)
   and config 5's stand-in (backpack, 131,072 rays): hit equal on every
   live lane, the material on >= 99.9% (camera) and >= 99.5% (bounce) of
   them, the floats of the agreeing lanes within `hit_agreement`'s limits
   (t, and p over |d|), >= 99% within HIT_CLOSE, triangle winners by
   original id (`tri_perm[slot]`) equal on >= 99.9% and otherwise ties;
40. xla renders: Cornell 512x512, 4 spp, depth 8 with `engine="xla"`
   against the megakernel route's image (per-channel z < 4: the two draw
   different random streams); the `many_media` probe (20 media, more than
   the kernels take) at 512x512, 4 spp, depth 16 through "auto", which
   must report "xla"; one Cornell training chunk (512x512, 2 spp, depth 8)
   on `compile_param_renderer(engine="xla")`; each with its Mrays/s and
   busy share and no hand kernel launched; then a Cornell render
   (512x512, 4 x 16 spp, depth 8) stopped after 2 of its 4 chunks and
   resumed from its checkpoint by a fresh renderer: equal to the
   uninterrupted render bit for bit;
41. `bench_all_torch.py`'s rows config 1, earth-grad and mesh-grad
   (BENCH_CONFIGS; its other rows repeat phases 16, 20 and 24) at
   `--spp-scale` BENCH_SPP_SCALE, each finite;
42. `parallel/`: (a) a world of one rank (NCCL), where config 3's training
   chunk (Cornell 512x512, 8 spp, depth 8, waves of 32,768, the record
   chunk launch) on a 1x1 mesh equals the unsharded chunk bit for bit,
   primal and gradients, and config 2 (big_scene1 800x450, 2 x 16 spp,
   depth 16) through `make_sharded_chunk_fn` and `render_linear` takes
   regen and equals the regen body run without a process group bit for bit
   (deterministic `index_add_`) and the unsharded regen render
   statistically (mean within 3% + 5e-3, correlation > 0.9); (b) two
   spawned ranks that share the card (gloo, `distributed.choose_backend`):
   the training chunk at (sp, dp) = (2, 1) and (1, 2) against (a)'s
   unsharded chunk (primal rtol 1e-6 / atol 1e-7, gradients within 2e-5
   of their scale), config 2 at (1, 2) on regen (statistically) and one
   16-spp chunk at (2, 1) on the megakernel route (kernel 1c) against
   `render.chunk_sums` over `Tracer.__call__` (rtol 2e-5, atol 1e-5),
   with each rank's launch counts (each route's kernel > 0), Mrays/s and
   the ms of an sp `all_reduce` of a (512*512/2, 3) float32 array; then
   whether NCCL takes two ranks on one card.
43. the reference depth 50 with russian roulette from bounce 4: kernel
   1a's chunk launch on cornell_smoke and cornell_box and kernel 1d-t's on
   `triangles` and `models.probes.mesh_box` (a closed box of triangles;
   64 wide, 4 spp) equal to `trace_chunk_reference` bit for bit on every
   row, one launch each, and roulette changing the plain chunk on every
   scene but `triangles` (whose paths end before bounce 4); the chunks of
   cornell_smoke, `triangles` and mesh_box against their depth-50 JAX
   goldens (`<scene>_d50.npz`, `golden_cmp`'s rule) and the regen chunk
   of big_scene1 against `big_scene1_regen_d50.npz` (per-channel z < 4,
   the stream equal, the steps within 10%); then every scene of `tools/render_gallery_torch.py`'s
   PLAN, and `earth` with a synthetic 1024x512 map, at its PLAN width, one
   16-spp chunk, depth 50 (`render_scene`, through `render()`): finite and
   lit, on the engine `route` names (regen for big_scene1, earth with its
   map and the 100k-triangle stand-ins, the megakernel for the rest), with
   that engine's kernel alone launched (one `rt_trace_chunk`; `rt_hit`
   once a step of the render's own chunk, its steps read from the
   `PhaseTimer` `render()` fills), each with its seconds, Mrays/s and
   peak of allocated device memory; then `cli.main` on cornell_box at
   the CLI's defaults (1200x1200, 10 x 100 spp, depth 50): ten
   `rt_trace_chunk` launches and no other, a lit PNG;
44. `python3 tools/roofline_torch.py` in a process of its own: every
   line finite, the north-star phases A, B, E and F launching
   `rt_trace_rays`, `rt_walk_packed`, `rt_walk_packed` and
   `rt_trace_chunk`, C and D no hand kernel, each with a device time
   above 0 (A, B, E and F with their hand kernel seen by the profiler);
   the bf16 matmul rate between 10% and 105% of the card's bf16 peak
   (`roofline.card_peaks`).

Prints each phase's seconds, a JSON line of kernels, the card's name and
power limit, and as its last line `{"ok": true, "device": {...}}`.  Exits
non-zero, with no result line, when anything fails, when there is no CUDA
device, or when the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "raytracing_gpu_tpu_torch/ops/csrc"
KERNEL_SOURCE = f"{CSRC}/megakernel.cuh"
REPLACES = "raytracing_gpu_tpu/ops/pallas_trace.py:1703"
HIT_SOURCE = f"{CSRC}/hit.cu"
HIT_REPLACES = "raytracing_gpu_tpu/ops/pallas_trace.py:2252"
TRI_SOURCE = f"{CSRC}/megakernel.cuh"  # tri_bvh_walk, kFeatTriBvh
FMA_SOURCE = f"{CSRC}/roofline.cu"
FMA_REPLACES = "tools/roofline.py:121"
DATA = os.path.join(ROOT, "tests", "data", "torch_port")
GOLDEN = os.path.join(DATA, "cornell_32.npz")
GRAD_GOLDEN = os.path.join(DATA, "cornell_grad_32.npz")
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
DENSE_SCENES = ("basic", "first", "two_spheres", "two_perlin_spheres",
                "cornell_smoke")
RECORD_SCENES = ("first", "cornell_smoke")
GOLDEN_MEAN_TOL = 3e-3  # see golden_cmp
# BASELINE configs 1 and 4 (bench_all.py:16-20, :372-378) as phases 15 and
# 16: (phase, config, scene, width, spp per chunk, chunks, depth)
BASELINE = ((15, 1, "first", 400, 16, 1, 8),
            (16, 4, "cornell_smoke", 512, 32, 4, 16))
RR_RENDER = ("cornell_smoke", 512, 32, 16, 2)  # scene, width, spp, depth, rr
# phase 37's whole chunks (label, scene, width, spp, depth), each one
# chunk of a render above
CHUNKS = (("Cornell", "cornell_box", 512, 16, 8),
          ("config 1", "first", 400, 16, 8),
          ("config 4", "cornell_smoke", 512, 32, 16),
          ("big_scene1", "big_scene1", 800, 8, 16),
          ("triangles", "triangles", 400, 16, 8))
# phase 38's whole training chunks (label, scene, width, spp, depth, ray
# batch), each one chunk of a training render above (phases 12 and 30)
TRAIN_CHUNKS = (("Cornell", "cornell_box", 512, 8, 8, 32768),
                ("big_scene1", "big_scene1", 800, 16, 16, 32768),
                ("triangles", "triangles", 400, 8, 8, 65536))
# phase 38's backpack chunk through the forward chunk launch: width (its
# 800x600 frame), spp, depth, ray batch
BACKPACK_CHUNK = (800, 4, 16, 65536)
PLAIN_CHUNK_RAYS = 3 << 20  # rays a plain record walk takes at once on the card
RR_MEAN_TOL = 0.05
FMA_CHECK_STEPS = (1, 7, 8, 13, 21)  # the unrolled-by-8 loop and its tail
BIG = "big_scene1"
# big_scene1 on the megakernel route (below 16 spp per chunk): phase 19;
# (width, spp per chunk, chunks, depth)
BIG_MEGAKERNEL = (800, 8, 1, 16)
# BASELINE config 2 (bench_all.py:17, :374, :432; 2 chunks x 16 spp at this
# shape, bench_all.py:110) as phase 20
CONFIG2 = (800, 16, 2, 16)
ROUTES_AGREE = (400, 16, 16)  # width, spp, depth of phase 19's comparison
Z_LIMIT = 4.0       # standard errors of a statistical agreement
HIT_TIE_LIMIT = 2e-3  # t of two triangles that tie across an edge (HIT_CLOSE)
CAPTURE_STEP = 40   # a regen step whose wave is full and still refilling
HIT_RAYS = 65536
# the every-lane checks of the warp-cooperative walks: a partial last warp
PARTIAL_HIT = HIT_RAYS + 37   # rt_hit's waves (phases 18, 22)
PARTIAL_WAVE = 32768 + 37     # the sphere-BVH and tie-scene waves (22, 27)
# BASELINE config 5 (bench_all.py:21, :377: 800x600 with the scene's 16:9
# camera, as the JAX package renders it), phase 24: (width, spp per chunk,
# chunks, depth), its wave (bench_all.py:441) and its bounded profiled
# sub-run; config 5-rr (bench_all.py:445-447) adds russian roulette
CONFIG5 = (800, 64, 1, 16)  # one of the config's 4 chunks (time budget)
CONFIG5_ASPECT = 4 / 3
CONFIG5_RAY_BATCH = 131072
CONFIG5_RR_START = 2
CONFIG5_PROFILED_SPP = 16
WAVEFRONT_ROUTE = (800, 8, 1, 16)  # phase 25, below 16 spp a chunk
WAVEFRONT_AGREE = (160, 16, 16)    # width, spp, depth of the routes' check
TRIANGLES_ROUTE = (400, 16, 1, 8)  # phase 26
REDUCED_RAYS = 8192  # phase 22's waves: the plain walk over 100k triangles
MESH_WAVE = 3        # the centre 65,536-pixel wave of an 800x600 frame
# Phases 27-32 (the training path beyond the Cornell box)
REC_SCENES = ("two_spheres", "two_perlin_spheres", "big_scene1", "triangles")
# BASELINE config 2's scene in training (bench.py's wave): phases 30, 31;
# (width, spp per chunk, chunks, depth, ray batch)
BIG_TRAIN = (800, 16, 2, 16, 32768)
TRI_TRAIN = (400, 8, 1, 8, 65536)  # `triangles` in training, phase 30
# bench_all.py's mesh-grad row (:213-254): phase 32
MESH_GRAD = (800, 4, 1, 8, 65536)
RAY_WAVE = 65536   # phase 28's waves of torch-drawn camera rays
RAY_BYTES = 28     # a ray plane's o, d and tm read once
P_BYTES = 12       # a hit-point entry's x, y, z written once
UV_BYTES = 8       # a uv entry's u and v written once
# Phases 33-36 (image textures: kernel 1b's uv planes), on synthetic maps
UV_WAVE = 65536                  # the uv waves' rays (backpack: REDUCED_RAYS)
PROBE_WAVE = (512, 8)            # the image probe: width (square), depth
SPHERES_WAVE = (800, 16)         # the image spheres (16:9): width, depth
EARTH_MAP = (512, 1024, 7)       # earth's map: height, width, seed
BACKPACK_MAP = (1024, 1024, 9)   # config 5's diffuse map
# earth through render() (phase 34): width, spp per chunk, chunks, depth
EARTH_RENDER = (800, 16, 2, 8)
# bench_all.py's earth-grad row (:168-210), phase 35: (width, spp per
# chunk, chunks, depth, ray batch)
EARTH_GRAD = (256, 8, 1, 8, 65536)
PROBE_GRAD = (128, 4, 1, 8, 16384)  # the image probe's atlas gradients
# Phases 39-41 (the pure-torch "xla" engine, checkpoint and resume,
# bench_all_torch.py's rows)
ORACLE_RAYS = {"big_scene1": 65536, "backpack": 131072}  # rt_hit's waves
ORACLE_MAT_FLOOR = (0.999, 0.995)  # camera rays, scattered rays
ORACLE_TRI_ID_FLOOR = 0.999  # triangle winners with equal ids (else a tie)
XLA_CORNELL = (512, 4, 1, 8)       # width, spp per chunk, chunks, depth
XLA_MEDIA = (512, 4, 1, 16)        # the many_media probe, through "auto"
XLA_TRAIN = (512, 2, 1, 8, 32768)  # one Cornell training chunk
RESUME = (512, 16, 4, 8, 2)        # width, spp, chunks, depth, stop after
XLA_SUB_SPP = 1  # phase 40's profiled sub-runs: the same waves, 1 spp
BENCH_SPP_SCALE = 16               # bench_all_torch.py's rows in phase 41
BENCH_CONFIGS = ("1",)             # its forward rows there
# Phase 42 (parallel/): config 3's training chunk (Cornell: width, spp,
# depth, ray batch) and config 2's render (big_scene1: width, spp per
# chunk, chunks, depth, ray batch), on a world of one rank and on two ranks
# that share the card, at (sp, dp) = (2, 1) and (1, 2)
PAR_TRAIN = (512, 8, 8, 32768)
PAR_SERVE = (800, 16, 2, 16, 65536)
PAR_MESHES = ((2, 1), (1, 2))
PAR_DEADLINE = 240.0     # the two-rank world
NCCL_DEADLINE = 45.0     # the NCCL probe on two ranks of one card
PAR_ALL_REDUCE = (512 * 512 // 2, (8, 32))  # rows of the array, repetitions
PAR_STAT = (0.03, 5e-3, 0.9)  # regen: mean within 3% + 5e-3, correlation
# Phase 43 (the reference depth 50, russian roulette from bounce 4): kernel
# 1a's and 1d-t's chunk launch against the plain chunk at DEEP_WIDTH wide,
# DEEP_SPP spp; the depth-50 goldens; every gallery scene at its PLAN width
# (tools/render_gallery_torch.py) but GALLERY_SPP spp in one chunk (regen
# takes >= 16 spp a chunk), plus earth with EARTH_MAP; the CLI's defaults
DEEP_DEPTH, DEEP_RR_START = 50, 4
DEEP_CHUNK_SCENES = ("cornell_smoke", "cornell_box", "triangles",
                     "mesh_box")
DEEP_NO_RR = ("triangles",)  # no path of its chunk reaches bounce 4
DEEP_WIDTH, DEEP_SPP = 64, 4
DEEP_GOLDENS = ("cornell_smoke", "triangles", "mesh_box")
GALLERY_SPP = 16
GALLERY_REGEN = ("big_scene1", "door", "backpack", "cup", "earth (map)")
LIT_MEAN = 0.01      # a rendered image's mean above this is lit
CLI_DEFAULT = dict(width=1200, spp=100, chunks=10, depth=50)  # cli.py
# Phase 44 (tools/roofline_torch.py): the hand kernel each north-star phase
# must launch, and the bf16 rate's share of the card's bf16 peak
ROOFLINE_KERNELS = {"walk_forward_kernel": "rt_trace_rays",
                    "walk_record_kernel": "rt_walk_packed",
                    "xla_shade_forward": None, "xla_shade_fwd_bwd": None,
                    "e2e_chunk_fwd_bwd": "rt_walk_packed",
                    "e2e_chunk_forward": "rt_trace_chunk"}
BF16_SHARE = (0.10, 1.05)
ROOFLINE_S = 300  # phase 44's limit on the tool's process
# The Cornell forward wave (65,536 rays, depth 8) of the kernel before it
# took spheres and media, H100 80GB HBM3 at 700 W (PERF.md, section 6)
CORNELL_WAVE_MS_BEFORE = "0.0293-0.0294"

# The H100 SXM's published peaks at a 700 W limit, printed beside the
# bounds for comparison only: every bound divides by the rates that phase 4
# takes from the card (the larger of measured and its attributes' peak).
SPEC_FP32_FLOPS = 67e12
SPEC_BYTES_PER_S = 3.35e12
# float32 operations (add, multiply, divide, sqrt, transcendental, min/max,
# compare) in csrc/megakernel.cuh, counted from its source; the integer PCG
# hashes are left out and a transcendental counts once, so the bound stays
# a lower bound.
OPS_CAMERA = 25        # camera_ray: two draws, su/sv, origin, direction, time
OPS_RECT = 14          # one rect test: guard, divide, two lerps, compares
OPS_BOX = 51           # one box slab test: transform, 3 divides, 6 slabs
OPS_SPHERE = 44        # one sphere candidate: center at tm, quadratic, roots
OPS_MEDIUM = 60        # one medium: interval, free path (log), compares
OPS_BOUNCE = 10        # per bounce: miss test, sphere 1/a, media 1/|d|
OPS_SCATTER = {0: 50,  # lambertian: face normal, normalize, draws, n + u
               1: 84,  # metal: + unit d, reflect, in_sphere, fuzz, test
               2: 105,  # dielectric: + Schlick and the refraction
               4: 47}  # isotropic: face normal, in_sphere
OPS_FWD_CONT = 3       # megakernel_fwd's throughput multiply per bounce
OPS_FWD_END = 9        # megakernel_fwd's path term (0 + t x) into its row sum
OPS_NODE = 25          # one BVH node: 6 slabs, their min/max, the tests
OPS_WALK = 19          # per walk: the guarded 1/d and the sphere 1/a
# csrc/hit.cu per live ray: front face, normalize, the hit point; and a
# sphere winner's uv through the polynomial atan2 and acos
OPS_HIT_END = 27
OPS_SPHERE_UV = 55
OPS_TRI = 57           # one Moller-Trumbore candidate and its test
OPS_TRI_WALK = 6       # the triangle walk's guarded 1/d
OPS_TRI_WIN = 17       # a triangle winner's interpolated normal
HIT_IN_BYTES = 29      # o, d, tm float32 and alive uint8 per ray
HIT_OUT_BYTES = 40     # packed int32, p, u, v, normal, slot float32
# Bytes a triangle walk reads (csrc/megakernel.cuh visit_node, tri_bvh_walk,
# warp_bvh_walk): per node tested its box and leaf start, per link column
# followed 4, per real slot of a leaf tested its 9 geometry floats (a pad
# slot is no work); per winning megakernel row its vertex normals and
# shading columns (9 + 12 floats), read once after the walk.  The uv and
# pad columns of the 40-column row are never read.
TRI_NODE_BYTES = 28
TRI_LINK_BYTES = 4
TRI_GEOM_BYTES = 36
TRI_WIN_BYTES = 84


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    from raytracing_gpu_tpu_torch.utils.profiling import card_line as read

    line = read()
    if line is None:
        raise RuntimeError("nvidia-smi could not read the card's name and "
                           "power limit")
    return line


def compare(got, want, depth: int, exact_floor: float = EXACT_FLOOR) -> dict:
    """The stated tolerances: depth 1 -> allclose(rtol=1e-5, atol=1e-5);
    deeper -> >= 99% of rows within atol 1e-3 * max|want| and every channel
    mean within 1e-3 relative (cosf/sinf may differ by a few ulp between the
    kernel and torch, so a few paths could diverge after a bounce).  At every
    depth, also at least `exact_floor` of the values equal bit for bit."""
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
    res["ok"] = res["ok"] and exact >= exact_floor
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
    """Profile one call of `fn` with torch.profiler, recording device
    activity alone (`utils.profiling.kernel_times`): device time summed by
    kernel name, wall time, the device's busy share of the wall, and the
    seconds the profiler spent around the call (start, trace collection,
    `key_averages`)."""
    import torch

    from raytracing_gpu_tpu_torch.utils.profiling import kernel_times

    walls = []

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    t_start = time.perf_counter()
    times = kernel_times(timed)
    wall = walls[0]
    by_kernel = {k[:60]: (t * 1e3, n) for k, (t, n) in times.items()}
    busy = sum(ms for ms, _ in by_kernel.values())
    return dict(wall_ms=wall * 1e3, device_ms=busy,
                busy_share=busy / (wall * 1e3) if busy else None,
                profiler_s=time.perf_counter() - t_start - wall,
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


class Ceilings:
    """The rates every bound divides by, set in phase 4: for each of the
    float32 FMA rate and the memory rate, the larger of what the probe
    measured and the card's peak from its attributes."""

    flops = bytes_per_s = None


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(least milliseconds, what bounds it) for `ops` float32 operations
    and `nbytes` bytes moved, over the card's rates (`Ceilings`)."""
    t_ops, t_bytes = ops / Ceilings.flops, nbytes / Ceilings.bytes_per_s
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def spec_bound_ms(ops: float, nbytes: float) -> float:
    """The same bound over the published peaks, for comparison."""
    return max(ops / SPEC_FP32_FLOPS, nbytes / SPEC_BYTES_PER_S) * 1e3


def plane_counts(scene, plane) -> dict:
    """The work counts (`trace_pixels_reference(counts=...)`'s keys) of the
    paths a record plane (max_depth, n) describes."""
    import torch

    plane = plane.detach().cpu().to(torch.int64)
    live, cont = live_counts(plane)
    kinds = torch.from_numpy(scene.materials.kind).to(torch.int64)
    kind = kinds[(plane & 0xFFFF)[(plane & (1 << 16)) != 0]]
    return dict(live=live, cont=cont, nodes=0, rows=0, tri_nodes=0,
                tri_rows=0, tri_wins=0,
                scatter={k: int((kind == k).sum()) for k in OPS_SCATTER})


def wave_ops(bake, counts: dict, n: int) -> float:
    """float32 operations of a forward wave of n rays that does the work in
    `counts`: the camera and the path's end per ray; per live bounce the
    closest hit over every record (or the sphere-BVH walk's node and row
    tests) and the media; per hit that is not a light the scatter of its
    material kind; per continued bounce the throughput."""
    bvh = len(bake.sph_nodes) > 0
    hit_ops = (len(bake.rects) * OPS_RECT + len(bake.boxes) * OPS_BOX
               + (OPS_WALK if bvh else len(bake.sphere_table) * OPS_SPHERE)
               + (len(bake.sphere_media) + len(bake.box_media)) * OPS_MEDIUM
               + OPS_BOUNCE)
    scatter = sum(counts["scatter"].get(k, 0) * ops
                  for k, ops in OPS_SCATTER.items())
    tri = (counts["live"] * OPS_TRI_WALK if len(bake.tri_nodes) else 0)
    return (n * (OPS_CAMERA + OPS_FWD_END) + counts["live"] * hit_ops
            + counts["nodes"] * OPS_NODE + counts["rows"] * OPS_SPHERE
            + tri + counts["tri_nodes"] * OPS_NODE
            + counts["tri_rows"] * OPS_TRI + counts["tri_wins"] * OPS_TRI_WIN
            + scatter + counts["cont"] * OPS_FWD_CONT)


def real_sphere_bytes(tracer) -> int:
    """Bytes of the sphere rows that are not pads (radius != 0): a pad row
    of a BVH leaf is no work, and the kernels skip it."""
    return 4 * int((tracer.sphere_table[:, 8] != 0).sum()) * \
        tracer.sphere_table.shape[1]


def table_bytes(tracer) -> int:
    """Bytes of the megakernels' tables other than the triangle BVH's, each
    read once, the sphere table's real rows only."""
    rest = tracer._checked_tables().tensors[:6]
    return (4 * sum(t.numel() for t in rest) - 4 * tracer.sphere_table.numel()
            + real_sphere_bytes(tracer))


def leaf_real(ids, leaf_k: int):
    """Real slots of each leaf of a leaf-contiguous triangle table whose
    slot ids are `ids` (-1 on a pad): `tri_bytes`'s counts."""
    import torch

    return torch.from_numpy((ids.reshape(-1, leaf_k) >= 0).sum(1))


def tri_bytes(reads, real, win_bytes: int) -> int:
    """Bytes of a triangle BVH's tables that the walks in `reads`
    (`cuda_trace.tri_reads`, None without triangles) touch, each once: the
    nodes tested, the link columns followed, the real slots of the leaves
    tested (`real`, from `leaf_real`) and the winners' `win_bytes`."""
    if reads is None:
        return 0
    return (TRI_NODE_BYTES * int(reads["nodes"].sum())
            + TRI_LINK_BYTES * int(reads["links"].sum())
            + TRI_GEOM_BYTES * int(real[reads["leaves"].cpu()].sum())
            + win_bytes * int(reads["won"].sum()))


class Phase:
    """Prints a phase's seconds when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        print(f"[phase] {self.name}: {time.perf_counter() - self.t0:.2f} s",
              flush=True)
        return False




def check_scene_kernel(tracer, sd, base: int, label: str) -> None:
    """The forward kernel against its plain version on the card at 64x64,
    4 spp, depth 1 and 8 (phase 5's rules)."""
    import torch

    from raytracing_gpu_tpu_torch.ops import cuda_trace

    for depth in (1, 8):
        got, want = [], []
        for s in range(4):
            seed = cuda_trace.wave_seed(base, s, 0)
            got.append(tracer.trace_pixels(sd.camera, 64, 64, 0, 4096, seed,
                                           max_depth=depth))
            want.append(cuda_trace.trace_pixels_reference(
                tracer.bake, sd.camera, 64, 64, 0, 4096, seed,
                max_depth=depth, device=tracer.device))
        torch.cuda.synchronize()
        cmp = compare(torch.cat(got), torch.cat(want), depth)
        print(f"[kernel-vs-plain] {label} 64x64 4spp depth {depth}: {cmp}")
        if not cmp["ok"]:
            raise AssertionError(f"{label}: kernel disagrees with plain at "
                                 f"depth {depth}")


def golden_cmp(got, want) -> dict:
    """A dense scene's chunk against its JAX golden: >= 99% of the pixels
    within atol 1e-3 * max and every channel mean within GOLDEN_MEAN_TOL
    relative.  XLA's sin/cos/log/exp on the CPU and CUDA's differ by an ulp
    here and there, and one path that diverges after a bounce moves a mean
    of these 576-1024-pixel chunks on its own: over 16 keys per scene
    (`tools/golden_spread.py`) at most one pixel of a chunk diverged
    outside the perlin scene, and the worst mean moved by 2.52e-3 (`first`);
    the kernel's parity with its plain version is held bit for bit
    elsewhere."""
    res = compare(got, want, 3, exact_floor=0.0)
    res["ok"] = res["frac_within"] >= 0.99 and \
        res["mean_rel_err"] <= GOLDEN_MEAN_TOL
    return res


def golden_settings(g):
    from raytracing_gpu_tpu_torch import RenderSettings

    aspect = float(g["aspect_ratio"]) if "aspect_ratio" in g else 1.0
    return RenderSettings(image_width=int(g["image_width"]),
                          aspect_ratio=aspect,
                          spp_per_chunk=int(g["spp_per_chunk"]),
                          num_chunks=1, max_depth=int(g["max_depth"]),
                          ray_batch=int(g["ray_batch"]),
                          t_min=float(g["t_min"]),
                          rr_start=int(g["rr_start"]) if "rr_start" in g
                          else 0)


def time_wave(tracer, sd, st, base: int, card: str, label: str,
              wave_id: int = 1, plain_reps: int = 3) -> dict:
    """A render's main wave (wave `wave_id` of its grid, full width): the
    kernel against its plain version on the same seed (phase 5's rules),
    kernel device time (device held), loop time, the plain version's time
    (over `plain_reps` calls after a warm-up), and the bound from the work
    the plain version counts on the same seed."""
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    h, w, n, depth = st.image_height, st.image_width, st.ray_batch, \
        st.max_depth
    pix = n * wave_id if h * w > n * wave_id else 0
    wave = tracer.bind(sd.camera, h, w, depth, st.t_min, st.rr_start)
    seed = cuda_trace.wave_seed(base, 1, 1)
    counts = {}
    cmp = compare(wave(pix, n, seed), cuda_trace.trace_pixels_reference(
        tracer.bake, sd.camera, h, w, pix, n, seed, depth, st.t_min,
        tracer.device, st.rr_start, counts=counts), depth)
    print(f"[kernel-vs-plain] {label} main wave of {n} rays, depth {depth}: "
          f"{cmp}")
    if not cmp["ok"]:
        raise AssertionError(f"{label}: kernel disagrees with plain on its "
                             "main wave")

    def kernel_wave(r):
        return wave(pix, n, cuda_trace.wave_seed(base, r, 1))

    ms = event_ms(kernel_wave, reps=50, hold_device=True)
    loop_ms = event_ms(kernel_wave, reps=50)
    plain_ms = event_ms(lambda r: cuda_trace.trace_pixels_reference(
        tracer.bake, sd.camera, h, w, pix, n, cuda_trace.wave_seed(base, r, 1),
        depth, st.t_min, tracer.device, st.rr_start), reps=plain_reps)
    ops = wave_ops(tracer.bake, counts, n)
    nbytes = 12 * n + table_bytes(tracer) + tri_bytes(
        counts["tri_read"], leaf_real(tracer.bake.tri_ids,
                                      cuda_trace.TRI_LEAF_K), TRI_WIN_BYTES)
    bound_ms, bound_by = bound(ops, nbytes)
    live, cont = counts["live"], counts["cont"]
    print(f"[time] {label} wave of {n} rays, depth {depth}: kernel {ms:.6f} "
          f"ms on the device ({loop_ms:.6f} ms per call in a Python loop), "
          f"plain {plain_ms:.6f} ms; bound {bound_ms:.6f} ms by {bound_by} "
          f"({ops:.0f} ops from {live} live, {cont} continued bounces, "
          f"{counts['nodes']} node and {counts['rows']} sphere-row tests, "
          f"{counts['tri_nodes']} triangle-node and {counts['tri_rows']} "
          f"triangle tests, {counts['tri_wins']} triangle winners; "
          f"{nbytes} bytes; {spec_bound_ms(ops, nbytes):.6f} ms over the "
          f"spec sheet), on "
          f"{card}")
    return dict(ms=ms, loop_ms=loop_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, live_bounces=live, cont_bounces=cont,
                node_tests=counts["nodes"], row_tests=counts["rows"],
                tri_node_tests=counts["tri_nodes"],
                tri_tests=counts["tri_rows"], pix_base=pix,
                max_abs_err=cmp["max_abs_err"], exact_frac=cmp["exact_frac"])


def render_counted(sd, st, dev, card: str, label: str, png: str) -> dict:
    """`render()` with the launch counts set to 0 just before and read just
    after: exactly one chunk launch of the forward kernel a chunk, and no
    per-wave, ray-plane, record or hit launch; a finite, lit image written
    to `png`; Mrays/s, the busy share of a profiled repeat, and a repeat's
    set-up and chunk milliseconds."""
    import numpy as np
    import torch

    from raytracing_gpu_tpu_torch import render, render_linear
    from raytracing_gpu_tpu_torch.engine import film
    from raytracing_gpu_tpu_torch.ops import cuda_trace
    from raytracing_gpu_tpu_torch.utils.profiling import PhaseTimer

    expected = st.num_chunks
    render(sd.scene, sd.camera, st.with_(num_chunks=1, spp_per_chunk=1),
           device=dev)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    img = render(sd.scene, sd.camera, st, device=dev)
    wall = time.perf_counter() - t0
    launches = cuda_trace.Tracer.chunk_launches
    stray = (cuda_trace.Tracer.launches + cuda_trace.Tracer.ray_launches
             + record_launches() + cuda_trace.Tracer.hit_launches)
    rays = st.num_pixels * st.rays_per_pixel
    print(f"[main] render {label} {st.image_width}x{st.image_height} "
          f"{st.rays_per_pixel}spp depth {st.max_depth}: {wall:.6f} s, "
          f"{rays / wall / 1e6:.6f} Mrays/s, chunk launches {launches} "
          f"(expected {expected}), other launches {stray} on {card}")
    if launches != expected or stray != 0:
        raise AssertionError(f"{label}: {launches} chunk and {stray} other "
                             f"kernel launches, expected {expected} and 0")
    if (img.shape != (st.image_height, st.image_width, 3)
            or not np.isfinite(img).all()):
        raise AssertionError(f"{label}: bad image: shape {img.shape}, "
                             f"finite {np.isfinite(img).all()}")
    if not 0.05 < float(img.mean()) < 0.999:
        raise AssertionError(f"{label}: implausible image mean {img.mean()}")
    os.makedirs(os.path.dirname(os.path.abspath(png)), exist_ok=True)
    film.write_png(png, img)
    print(f"[main] {label} image mean {img.mean():.6f} -> {png}")
    prof = device_busy(lambda: render(sd.scene, sd.camera, st, device=dev))
    # the profiler slows the host, not the device: its device time over the
    # counted render's wall is the busy share of that render
    busy = prof["device_ms"] / (wall * 1e3)
    print(f"[main] {label} profiled repeat of the render: {prof}")
    print(f"[main] {label} device busy share of the counted render: "
          f"{busy:.6f} ({prof['device_ms']:.3f} ms of device time in "
          f"{wall * 1e3:.3f} ms) on {card}")
    # where a repeat's wall goes: the renderer's set-up (the bake, the
    # tables' upload, the launch's binding) and the chunks
    timer = PhaseTimer()
    render_linear(sd.scene, sd.camera, st, device=dev, timer=timer)
    phases = {k: v * 1e3 for k, v in timer.phases.items()}
    print(f"[main] {label} a repeat's phases (ms): {phases} on {card}")
    return dict(launches=launches, wall_s=wall, mrays_per_s=rays / wall / 1e6,
                busy_share=busy, profiled_busy_share=prof["busy_share"],
                image_mean=float(img.mean()),
                build_ms=phases.get("build"), trace_ms=phases.get("trace"))


def held_ms(launches: list, group: int = 44) -> float:
    """Device milliseconds of the calls in `launches`, one after another,
    each group queued behind a `torch.cuda._sleep` (`event_ms`, 2 reps):
    the groups are few enough calls for the host to enqueue while the
    device is held."""
    return sum(event_ms(lambda r, g=launches[k:k + group]: [f(r) for f in g],
                        reps=2, hold_device=True)
               for k in range(0, len(launches), group))


def time_chunk(sd, st, base: int, card: str, label: str) -> dict:
    """One sample chunk of the megakernel route (`compile_renderer`, one
    chunk launch) against the same chunk a wave at a time, the per-wave
    kernel launches' sums added in order, and against the plain version on
    the card (`cuda_trace.trace_chunk_reference`): all
    three equal bit for bit on every row.  Times the chunk launch and the
    per-wave launches (device held), the chunk's call and the per-wave loop
    with its slice-adds (host and device), and the plain chunk
    (`trace_chunk_reference`, counting its work); the bound is the whole
    chunk's float32 operations over the card's rate (the sum of its waves'
    operation bounds) or its bytes (the outputs and tables once, a
    triangle table's parts that the walks read) over its memory rate."""
    import torch

    from raytracing_gpu_tpu_torch import compile_renderer
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    dev = torch.device("cuda", torch.cuda.current_device())
    chunk = compile_renderer(sd.scene, sd.camera, st, dev)
    if chunk.engine_name != "megakernel":
        raise AssertionError(f"{label}: route {chunk.engine_name}")
    tracer = cuda_trace.Tracer(sd.scene, dev)
    h, w, b, depth = st.image_height, st.image_width, st.ray_batch, \
        st.max_depth
    b = min(b, -(-h * w // 8) * 8)
    rows = cuda_trace.chunk_rows(h, w, b)
    waves = [(s, bid) for s in range(st.spp_per_chunk)
             for bid in range(rows // b)]
    wave = tracer.bind(sd.camera, h, w, depth, st.t_min, st.rr_start)

    def per_wave(seed_base: int) -> torch.Tensor:
        sums = torch.zeros((rows, 3), dtype=torch.float32, device=dev)
        for s, bid in waves:
            sums[bid * b:(bid + 1) * b] += wave(
                bid * b, b, cuda_trace.wave_seed(seed_base, s, bid))
        return sums

    got, by_wave = chunk(base), per_wave(base)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = {}
    plain = cuda_trace.trace_chunk_reference(
        tracer.bake, sd.camera, h, w, base, st.spp_per_chunk, b, depth,
        st.t_min, dev, st.rr_start, counts=counts)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ops = wave_ops(tracer.bake, counts, rows * st.spp_per_chunk)
    same = torch.equal(got, by_wave) and torch.equal(got, plain)
    print(f"[chunk-vs-waves-vs-plain] {label} {w}x{h} {st.spp_per_chunk}spp "
          f"depth {depth}, {rows} rows in {len(waves)} waves of {b}: equal "
          f"bit for bit on every row {same} (chunk vs waves "
          f"{torch.equal(got, by_wave)}, vs plain {torch.equal(got, plain)})")
    if not same:
        raise AssertionError(f"{label}: the chunk launch differs from its "
                             "waves or from the plain version")
    ms = event_ms(lambda r: chunk(base + r), reps=5, hold_device=True)
    loop_ms = event_ms(lambda r: chunk(base + r), reps=5)
    waves_ms = held_ms([lambda r, s=s, bid=bid: wave(
        bid * b, b, cuda_trace.wave_seed(base + r, s, bid))
        for s, bid in waves])
    waves_loop_ms = event_ms(lambda r: per_wave(base + r), reps=3)
    nbytes = 12 * rows + table_bytes(tracer) + tri_bytes(
        counts["tri_read"], leaf_real(tracer.bake.tri_ids,
                                      cuda_trace.TRI_LEAF_K), TRI_WIN_BYTES)
    bound_ms, bound_by = bound(ops, nbytes)
    per_sm, sms, grid = chunk.occupancy
    print(f"[time] {label} chunk: one launch {ms:.6f} ms on the device "
          f"({loop_ms:.6f} ms a call), {len(waves)} per-wave launches "
          f"{waves_ms:.6f} ms on the device ({waves_loop_ms:.6f} ms a chunk "
          f"with the slice-adds), plain {plain_ms:.6f} ms; bound "
          f"{bound_ms:.6f} ms by {bound_by} ({ops:.0f} ops, {nbytes} bytes; "
          f"{spec_bound_ms(ops, nbytes):.6f} ms over the spec sheet); grid "
          f"{grid} blocks of 128 ({per_sm} an SM x {sms} SMs) for {rows} "
          f"rows, on {card}")
    return dict(chunk_ms=ms, chunk_loop_ms=loop_ms, waves_ms=waves_ms,
                waves_loop_ms=waves_loop_ms, chunk_plain_ms=plain_ms,
                chunk_bound_ms=bound_ms, chunk_bound_by=bound_by,
                waves=len(waves), rows=rows, blocks_per_sm=per_sm,
                grid_blocks=grid, chunk_max_abs_err=float(
                    (got - plain).abs().max()))


def add_counts(a: dict, b: dict) -> dict:
    """The plain versions' work counts of two runs together."""
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    out = {k: a[k] + b[k] for k in a if k not in ("scatter", "tri_read")}
    out["scatter"] = {k: a["scatter"].get(k, 0) + b["scatter"].get(k, 0)
                      for k in set(a["scatter"]) | set(b["scatter"])}
    out["tri_read"] = cuda_trace.merge_reads(a["tri_read"], b["tri_read"])
    return out


def kernel_registers(log: str, kernel: str, features: int):
    """ptxas' registers of instantiation `kernel<features>` (`rt::` kernels
    templated on their feature bits) in the build log, None if absent."""
    mangled = f"{len(kernel)}{kernel}ILj{features}E"
    entry = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "registers" in line and entry is not None and mangled in entry:
            return int(line.split("Used")[1].split("registers")[0])
    return None


def time_record_chunk(sd, st, base: int, card: str, label: str,
                      log: str) -> dict:
    """One training chunk's record walk in one launch
    (`Tracer.bind_record_chunk`) against the same waves' per-wave launches
    (`Tracer.bind_record`) stacked and against the plain chunk on the card
    (`cuda_trace.walk_chunk_reference`, a group of at most
    PLAIN_CHUNK_RAYS rays at a time): every plane equal bit for bit on every
    wave and lane.  Times the chunk launch and the per-wave launches
    (device held), the chunk's call, and the plain chunk (counting its
    work); the bound is the chunk's float32 operations over the card's rate
    (`record_wave_ops` of the plain chunk's counts) or its bytes (the
    planes written once, the tables read once, a triangle table's parts
    that the walks read) over its memory rate."""
    import torch

    from raytracing_gpu_tpu_torch.ops import cuda_trace

    dev = torch.device("cuda", torch.cuda.current_device())
    tracer = cuda_trace.Tracer(sd.scene, dev)
    h, w, depth, spp = (st.image_height, st.image_width, st.max_depth,
                        st.spp_per_chunk)
    b = min(st.ray_batch, -(-h * w // 8) * 8)
    launch = tracer.bind_record_chunk(sd.camera, h, w, depth, st.t_min, b,
                                      spp)
    nb, n_waves = launch.nb, spp * launch.nb
    if launch.groups != [(0, n_waves)]:
        raise AssertionError(f"{label}: groups {launch.groups}")
    wave = tracer.bind_record(sd.camera, h, w, depth, st.t_min)
    waves = [(s, bid) for s in range(spp) for bid in range(nb)]
    got = launch(base)
    by_wave = [wave(bid * b, b, cuda_trace.wave_seed(base, s, bid))
               for s, bid in waves]
    torch.cuda.synchronize()
    same_waves = all(torch.equal(g, torch.stack([x[k] for x in by_wave]))
                     for k, g in enumerate(got))
    del by_wave
    per_group = max(1, PLAIN_CHUNK_RAYS // b)
    counts, same_plain, err = None, True, 0.0
    plain_ms = 0.0
    for first in range(0, n_waves, per_group):
        count = min(per_group, n_waves - first)
        c = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = cuda_trace.walk_chunk_reference(
            tracer.bake, sd.camera, h, w, base, spp, b, depth, st.t_min, dev,
            first, count, counts=c)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        counts = c if counts is None else add_counts(counts, c)
        for g, v in zip(got, plain):
            part = g[first:first + count]
            same_plain = same_plain and torch.equal(part, v)
            err = max(err, float((part.double() - v.double()).abs().max()))
        del plain
    print(f"[record-chunk-vs-waves-vs-plain] {label} {w}x{h} {spp}spp depth "
          f"{depth}, {n_waves} waves of {b}, {len(got)} planes: equal bit "
          f"for bit on every plane, wave and lane: vs waves {same_waves}, "
          f"vs plain {same_plain}")
    if not (same_waves and same_plain):
        raise AssertionError(f"{label}: the record chunk launch differs from "
                             "its waves or from the plain version")
    del got
    ms = event_ms(lambda r: launch(base + r), reps=5, hold_device=True)
    loop_ms = event_ms(lambda r: launch(base + r), reps=5)
    waves_ms = held_ms([lambda r, s=s, bid=bid: wave(
        bid * b, b, cuda_trace.wave_seed(base + r, s, bid))
        for s, bid in waves])
    n = n_waves * b
    ops = record_wave_ops(tracer.bake, counts, n, True)
    nbytes = record_wave_bytes(tracer, counts, n, depth, False)
    bound_ms, bound_by = bound(ops, nbytes)
    per_sm, sms, grid = launch.occupancy
    regs = kernel_registers(log, "megakernel_record",
                            tracer._record_features())
    print(f"[time] {label} training chunk's record walk: one launch "
          f"{ms:.6f} ms on the device ({loop_ms:.6f} ms a call), "
          f"{n_waves} per-wave launches {waves_ms:.6f} ms on the device, "
          f"plain {plain_ms:.6f} ms; bound {bound_ms:.6f} ms by {bound_by} "
          f"({ops:.0f} ops from {counts['live']} live and {counts['cont']} "
          f"continued bounces, {counts['nodes']} node and {counts['rows']} "
          f"sphere-row tests, {counts['tri_nodes']} triangle-node and "
          f"{counts['tri_rows']} triangle tests; {nbytes} bytes; "
          f"{spec_bound_ms(ops, nbytes):.6f} ms over the spec sheet); grid "
          f"{grid} blocks of 128 ({per_sm} an SM x {sms} SMs) for {n} rays; "
          f"megakernel_record<{tracer._record_features()}> {regs} registers; "
          f"on {card}")
    return dict(chunk_ms=ms, chunk_loop_ms=loop_ms, waves_ms=waves_ms,
                chunk_plain_ms=plain_ms, chunk_bound_ms=bound_ms,
                chunk_bound_by=bound_by, waves=n_waves, rays=n,
                blocks_per_sm=per_sm, grid_blocks=grid, registers=regs,
                chunk_max_abs_err=err)


def time_backpack_chunk(card: str, base: int, log: str) -> dict:
    """A whole chunk of config 5's frame (800x600, BACKPACK_CHUNK) through
    the forward chunk launch (`Tracer.bind_chunk`: the triangle walk of
    megakernel_fwd) against its per-wave launches' sums added in order,
    equal bit for bit on every row, both timed with the device held (the
    plain walk over 100k triangles takes too long for a whole chunk)."""
    import torch

    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    dev = torch.device("cuda", torch.cuda.current_device())
    sd = scenes.get("backpack")
    width, spp, depth, b = BACKPACK_CHUNK
    h = int(width / CONFIG5_ASPECT)
    tracer = cuda_trace.Tracer(sd.scene, dev)
    launch = tracer.bind_chunk(sd.camera, h, width, depth, 0.001, 0, b, spp)
    rows = cuda_trace.chunk_rows(h, width, b)
    waves = [(s, bid) for s in range(spp) for bid in range(rows // b)]
    wave = tracer.bind(sd.camera, h, width, depth)
    got = launch(base)
    sums = torch.zeros((rows, 3), dtype=torch.float32, device=dev)
    for s, bid in waves:
        sums[bid * b:(bid + 1) * b] += wave(bid * b, b,
                                            cuda_trace.wave_seed(base, s, bid))
    torch.cuda.synchronize()
    same = torch.equal(got, sums)
    print(f"[chunk-vs-waves] backpack {width}x{h} {spp}spp depth {depth}, "
          f"{len(waves)} waves of {b}: equal bit for bit on every row {same}")
    if not same:
        raise AssertionError("backpack: the chunk launch differs from its "
                             "waves")
    ms = event_ms(lambda r: launch(base + r), reps=3, hold_device=True)
    waves_ms = held_ms([lambda r, s=s, bid=bid: wave(
        bid * b, b, cuda_trace.wave_seed(base + r, s, bid))
        for s, bid in waves])
    regs = kernel_registers(log, "megakernel_fwd", tracer.bake.features())
    print(f"[time] backpack chunk: one launch {ms:.6f} ms on the device, "
          f"{len(waves)} per-wave launches {waves_ms:.6f} ms; "
          f"megakernel_fwd<{tracer.bake.features()}> {regs} registers, "
          f"{launch.occupancy[0]} blocks an SM, on {card}")
    return dict(backpack_chunk_ms=ms, backpack_waves_ms=waves_ms,
                backpack_waves=len(waves), backpack_registers=regs)


def backpack_chunk_bound(card: str, base: int, stride: int = 7) -> dict:
    """The bound of phase 38's whole backpack chunk (BACKPACK_CHUNK: 800x600,
    4 spp, depth 16, 32 waves of 65,536), counted on every `stride`-th
    wave of the chunk's (sample, wave) order by the plain walk on the card
    (`trace_pixels_reference(counts=)`; a whole chunk's plain walk over
    100k triangles takes minutes): the subset's operations scaled by the
    chunk's waves over the subset's, the bytes as the chunk's rows written
    once, the tables once and the triangle tables' parts that the subset's
    walks read (a lower bound of the whole chunk's, not scaled)."""
    import torch

    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    dev = torch.device("cuda", torch.cuda.current_device())
    sd = scenes.get("backpack")
    width, spp, depth, b = BACKPACK_CHUNK
    h = int(width / CONFIG5_ASPECT)
    tracer = cuda_trace.Tracer(sd.scene, dev)
    rows = cuda_trace.chunk_rows(h, width, b)
    waves = [(s, bid) for s in range(spp) for bid in range(rows // b)]
    sub = waves[::stride]
    counts = None
    t0 = time.perf_counter()
    for s, bid in sub:
        c = {}
        cuda_trace.trace_pixels_reference(
            tracer.bake, sd.camera, h, width, bid * b, b,
            cuda_trace.wave_seed(base, s, bid), depth, 0.001, dev, counts=c)
        counts = c if counts is None else add_counts(counts, c)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    ops = wave_ops(tracer.bake, counts, len(sub) * b) * len(waves) / len(sub)
    nbytes = 12 * rows + table_bytes(tracer) + tri_bytes(
        counts["tri_read"], leaf_real(tracer.bake.tri_ids,
                                      cuda_trace.TRI_LEAF_K), TRI_WIN_BYTES)
    bound_ms, bound_by = bound(ops, nbytes)
    print(f"[bound] backpack chunk {width}x{h} {spp}spp depth {depth}: "
          f"{bound_ms:.6f} ms by {bound_by} ({ops:.0f} ops, scaled from "
          f"{len(sub)} of its {len(waves)} waves {sub}, {counts['live']} live "
          f"bounces, {counts['tri_nodes']} node and {counts['tri_rows']} "
          f"triangle tests there; {nbytes} bytes; "
          f"{spec_bound_ms(ops, nbytes):.6f} ms over the spec sheet); the "
          f"plain walks {plain_s:.3f} s, on {card}")
    return dict(backpack_chunk_bound_ms=bound_ms,
                backpack_chunk_bound_by=bound_by,
                backpack_bound_waves=len(sub), backpack_plain_s=plain_s)


def chunk_fields(row: dict, chunk: dict) -> None:
    """Makes a record row's numbers its training chunk's (the main path's
    launch since the chunk launch), keeping its single wave's as wave_*."""
    for k in ("ms", "loop_ms", "plain_ms", "bound_ms", "bound_by",
              "max_abs_err", "exact_frac"):
        if k in row:
            row[f"wave_{k}"] = row.pop(k)
    row.update(ms=chunk["chunk_ms"], loop_ms=chunk["chunk_loop_ms"],
               plain_ms=chunk["chunk_plain_ms"],
               bound_ms=chunk["chunk_bound_ms"],
               bound_by=chunk["chunk_bound_by"],
               max_abs_err=chunk["chunk_max_abs_err"], chunk=chunk)


def camera_rays(sd, n: int, seed: int, dev):
    """n camera rays of a scene at random viewport points on the card (the
    lens and the shutter time drawn too), 10% of the lanes dead."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    s = torch.rand(n, generator=gen, device=dev)
    t = torch.rand(n, generator=gen, device=dev)
    o, d, tm = sd.camera.to(dev).get_rays(gen, s, t)
    alive = torch.rand(n, generator=gen, device=dev) >= 0.1
    return o.contiguous(), d.contiguous(), tm.contiguous(), alive


def scattered_rays(sd, tracer, rays, seed: int):
    """The rays that go on from the plain hit of `rays`, along the scattered
    directions (the regen step's resolve and scatter)."""
    import torch

    from raytracing_gpu_tpu_torch.engine import diff, wavefront
    from raytracing_gpu_tpu_torch.ops import cuda_trace
    from raytracing_gpu_tpu_torch.scene import materials

    o, d, tm, alive = rays
    hr = cuda_trace.hit_reference(tracer.bake, o, d, tm, alive)
    rec = wavefront.resolve_hit_packed(
        wavefront.pack_attr_table(sd.scene, tracer.bake.tri_perm, o.device),
        *hr, d)
    gen = torch.Generator(device=o.device).manual_seed(seed)
    sc = materials.scatter(sd.scene, diff.get_params(sd.scene, o.device), gen,
                           d, rec.p, rec.normal, rec.front_face, rec.u, rec.v,
                           rec.mat_id)
    alive = alive & rec.hit & sc.ok
    return (torch.where(alive[:, None], rec.p, o).contiguous(),
            torch.where(alive[:, None], sc.direction, d).contiguous(), tm,
            alive)


def hit_vs_plain(tracer, rays, label: str) -> dict:
    """`rt_hit` against `hit_reference` on the same rays on the card: the
    packed words equal on every lane and >= EXACT_FLOOR of the float values
    bit-exact."""
    import torch

    from raytracing_gpu_tpu_torch.ops import cuda_trace

    got = tracer.hit(*rays)
    want = cuda_trace.hit_reference(tracer.bake, *rays)
    torch.cuda.synchronize()
    res = cuda_trace.hit_agreement(got, want)
    res["max_abs_err"] = max(res["max_err"].values())
    res["slot_equal"] = bool(torch.equal(got.slot, want.slot))
    res["triangle_winners"] = int(((want.packed >> 20) & 1).sum())
    print(f"[hit-vs-plain] {label}: {res}")
    if not (res["packed_equal"] and res["exact_frac"] >= EXACT_FLOOR
            and res["slot_equal"]):
        raise AssertionError(f"{label}: hit kernel disagrees with plain")
    return res


def lane_masks(n: int, seed: int, dev) -> dict:
    """The lane masks of the every-lane checks: half the lanes dead at
    random, every other warp dead, and every lane live but warp 1's, which
    keeps one."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    lane = torch.arange(n, device=dev)
    one = torch.ones(n, dtype=torch.bool, device=dev)
    one[32:64] = False
    one[49] = True
    return {"half dead at random":
            torch.rand(n, generator=gen, device=dev) >= 0.5,
            "every other warp dead": (lane // 32) % 2 == 0,
            "one live lane in warp 1": one}


def hit_every_lane(tracer, rays, label: str) -> None:
    """`rt_hit` against `hit_reference` on the same rays, every output equal
    on every lane, under each of `lane_masks` (and the rays' own dead
    lanes): the warp-cooperative walk with threads past n and dead lanes
    in its warps."""
    import torch

    from raytracing_gpu_tpu_torch.ops import cuda_trace

    o, d, tm, alive = rays
    for what, mask in lane_masks(len(tm), 91, tm.device).items():
        live = (alive & mask).contiguous()
        got = tracer.hit(o, d, tm, live)
        want = cuda_trace.hit_reference(tracer.bake, o, d, tm, live)
        torch.cuda.synchronize()
        equal = {k: bool(torch.equal(g, w))
                 for k, g, w in zip(got._fields, got, want)}
        print(f"[hit-every-lane] {label}, {what} ({int(live.sum())} of "
              f"{len(tm)} live, {int(((want.packed >> 20) & 1).sum())} "
              f"triangle winners): {equal}")
        if not all(equal.values()):
            raise AssertionError(f"{label}, {what}: hit kernel differs from "
                                 "plain on some lane")


def waves_every_lane(sd, tracer, h: int, w: int, depth: int, seed: int,
                     label: str, forward: bool = True) -> None:
    """The record wave (camera rays and, kernel 1c, ray planes) and the
    forward wave of PARTIAL_WAVE lanes against their plain versions, every
    plane equal on every lane."""
    import torch

    from raytracing_gpu_tpu_torch.ops import cuda_trace

    n, dev = PARTIAL_WAVE, tracer.device
    runs = [("record", tracer.walk_packed_pixels(sd.camera, h, w, 0, n, seed,
                                                 max_depth=depth),
             cuda_trace.walk_packed_pixels_reference(
                 tracer.bake, sd.camera, h, w, 0, n, seed, depth,
                 device=dev))]
    o, d, tm, _ = camera_rays(sd, n, seed, dev)
    runs.append(("record on ray planes",
                 tracer.walk_packed(o, d, tm, seed, max_depth=depth),
                 cuda_trace.walk_packed_reference(tracer.bake, o, d, tm,
                                                  seed, depth)))
    if forward:
        runs.append(("forward", (tracer.trace_pixels(
            sd.camera, h, w, 0, n, seed, max_depth=depth).T,),
            (cuda_trace.trace_pixels_reference(
                tracer.bake, sd.camera, h, w, 0, n, seed, depth,
                device=dev).T,)))
    torch.cuda.synchronize()
    for what, got, want in runs:  # planes (depth or channel, n)
        equal = (len(got) == len(want)
                 and all(bool(torch.equal(g, v)) for g, v in zip(got, want)))
        live = int((got[0] != 0).any(0).sum())
        print(f"[wave-every-lane] {label} {what}, {n} lanes depth {depth}: "
              f"equal {equal} ({len(got)} planes, {live} lanes with output)")
        if not equal:
            raise AssertionError(f"{label} {what}: kernel differs from plain "
                                 "on some lane")


def z_scores(a, b):
    """Per channel, the mean over pixels of the per-pixel difference of two
    (npix, 3) estimates in standard errors (pixels are independent)."""
    import numpy as np

    diff = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return diff.mean(0) / (diff.std(0, ddof=1) / np.sqrt(len(diff)))


def hit_ops(bake, rays) -> tuple[float, dict]:
    """float32 operations of one hit launch on `rays`, from the plain walks
    of the same rays: per live ray the rects, boxes, finalize and the dense
    spheres or the sphere walk's set-up, per node and row test its
    operations, per sphere winner its uv; per live ray the triangle walk's
    set-up, per triangle node and candidate its operations."""
    import torch

    from raytracing_gpu_tpu_torch.ops import cuda_trace

    o, d, tm, alive = rays
    o3, d3 = tuple(o.unbind(1)), tuple(d.unbind(1))
    t_min, big = cuda_trace._f32(0.001), torch.full_like(tm, cuda_trace.BIG)
    plain = cuda_trace.hit_reference(bake, o, d, tm, alive)
    live = int(alive.sum())
    counts = dict(live=live, nodes=0, rows=0, tri_nodes=0, tri_rows=0,
                  sphere_winners=int(((plain.packed >> 21) & 1).sum()),
                  triangle_winners=int(((plain.packed >> 20) & 1).sum()),
                  tri_bytes=0)
    ops = live * (len(bake.rects) * OPS_RECT + len(bake.boxes) * OPS_BOX
                  + OPS_HIT_END)
    if len(bake.sph_nodes):
        walk = cuda_trace.sphere_walk_reference(bake, o3, d3, tm, t_min, big,
                                                alive, octant=True)
        counts.update(nodes=int(walk.nodes.sum()), rows=int(walk.rows.sum()))
        ops += live * OPS_WALK
    else:
        ops += live * len(bake.sphere_table) * OPS_SPHERE
    if len(bake.tri_hit_nodes):
        tw = cuda_trace.tri_walk_reference(bake, o3, d3, t_min, big, alive,
                                           octant=True)
        counts.update(tri_nodes=int(tw.nodes.sum()),
                      tri_rows=int(tw.rows.sum()),
                      tri_bytes=tri_bytes(cuda_trace.tri_reads(
                          tw, len(bake.tri_geom)), leaf_real(
                              bake.tri_perm, cuda_trace.HIT_TRI_LEAF_K), 0))
        ops += live * OPS_TRI_WALK
    ops += ((counts["nodes"] + counts["tri_nodes"]) * OPS_NODE
            + counts["rows"] * OPS_SPHERE + counts["tri_rows"] * OPS_TRI
            + counts["sphere_winners"] * OPS_SPHERE_UV)
    return ops, counts


def hit_bytes(tracer, n: int, counts: dict) -> int:
    """Bytes of one hit launch on n rays: the rays in, the outputs out, the
    tables other than the triangle tier's, each once (the sphere table's
    real rows only), and the parts of the triangle tier that the plain walk
    of the same rays reads (`hit_ops`'s counts; the tier reads geometry
    only, no winner's columns)."""
    return (n * (HIT_IN_BYTES + HIT_OUT_BYTES) + counts["tri_bytes"]
            + real_sphere_bytes(tracer) + 4 * sum(
                t.numel() for t in (tracer.rect_table, tracer.box_table,
                                    tracer.sph_nodes,
                                    tracer.sph_octant_links)))


def render_bases(st) -> list:
    """The chunk seeds `render(..., st)` draws (`render_linear`)."""
    import torch

    from raytracing_gpu_tpu_torch.ops import cuda_trace

    gen = torch.Generator().manual_seed(st.seed)
    return [cuda_trace.chunk_seed(gen) for _ in range(st.num_chunks)]


def capture_step(sd, st, dev, bases: list) -> tuple:
    """Regen chunks of `st` at the seeds `bases`, through
    `compile_regen_renderer`'s `debug_stats`: the rays of one steady-state
    step of the first (CAPTURE_STEP, whose wave is full and still
    refilling), each chunk's stats, and the hit launches they made."""
    from raytracing_gpu_tpu_torch.engine.wavefront import (
        compile_regen_renderer)
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    tracer = cuda_trace.Tracer(sd.scene, dev)
    bound_hit, captured = tracer.bind_hit, {}

    def capturing_bind_hit(t_min=0.001):
        launch, step = bound_hit(t_min), [0]

        def hit(o, d, tm, alive):
            if step[0] == CAPTURE_STEP:
                captured["rays"] = tuple(x.clone() for x in (o, d, tm, alive))
            step[0] += 1
            return launch(o, d, tm, alive)
        return hit

    tracer.bind_hit = capturing_bind_hit
    chunk = compile_regen_renderer(sd.scene, sd.camera, st, tracer=tracer,
                                   debug_stats=True, device=dev)
    launches = cuda_trace.Tracer.hit_launches
    stats = [chunk(int(b))[1] for b in bases]
    return captured["rays"], stats, cuda_trace.Tracer.hit_launches - launches


def record_vs_plain(got, want, label: str) -> dict:
    """A record kernel's planes against its plain version's on the card:
    `record_cmp` on the packed plane and >= EXACT_FLOOR of the float
    values (hit points, uv) bit-exact."""
    import torch

    res = record_cmp(got[0], want[0])
    res["planes"] = len(got)
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} planes, plain "
                             f"{len(want)}")
    if len(got) > 1:
        g, w = torch.stack(got[1:]).cpu(), torch.stack(want[1:]).cpu()
        res["float_exact_frac"] = float((g == w).double().mean())
        res["float_max_abs_err"] = float((g.double() - w.double()).abs()
                                         .max())
        res["ok"] = res["ok"] and res["float_exact_frac"] >= EXACT_FLOOR
    print(f"[record-vs-plain] {label}: {res}")
    if not res["ok"]:
        raise AssertionError(f"{label}: record kernel disagrees with plain")
    return res


def record_wave_ops(bake, counts: dict, n: int, camera: bool) -> float:
    """float32 operations of a record wave of n rays that does the work in
    `counts` (`trace_pixels_reference`'s, the same paths): the camera per
    ray when it makes the rays, per live bounce the closest hit (or the
    BVH walks' tests) and the media, per hit that is not a light its
    scatter; no albedo, throughput or radiance."""
    fwd = wave_ops(bake, counts, n)
    return (fwd - n * (OPS_CAMERA + OPS_FWD_END)
            - counts["cont"] * OPS_FWD_CONT + (n * OPS_CAMERA if camera else 0))


def record_wave_bytes(tracer, counts: dict, n: int, depth: int,
                      rays: bool) -> int:
    """Bytes of a record wave: the planes written once (4 B a packed entry,
    P_BYTES a hit-point entry, UV_BYTES a uv entry), the ray planes read
    once, the tables other than the triangle BVH's once, and the parts of
    the triangle BVH that the plain walk of the same rays reads."""
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    per_entry = (4 + (P_BYTES if tracer.need_p else 0)
                 + (UV_BYTES if tracer.need_uv else 0))
    return (per_entry * depth * n + (RAY_BYTES * n if rays else 0)
            + table_bytes(tracer) + tri_bytes(
                counts["tri_read"], leaf_real(tracer.bake.tri_ids,
                                              cuda_trace.TRI_LEAF_K),
                TRI_WIN_BYTES))


def time_record(label: str, card: str, kernel, plain, counts_fn, ops_fn,
                bytes_fn, reps: int = 50) -> dict:
    """A record kernel's wave timed: device time (device held), loop time,
    the plain version's time (one call), and the bound from the plain
    forward version's counts of the same paths (`counts_fn()`)."""
    ms = event_ms(kernel, reps=reps, hold_device=True)
    loop_ms = event_ms(kernel, reps=reps)
    plain_ms = event_ms(plain, reps=1)
    counts = counts_fn()
    ops, nbytes = ops_fn(counts), bytes_fn(counts)
    bound_ms, bound_by = bound(ops, nbytes)
    print(f"[time] {label}: kernel {ms:.6f} ms on the device ({loop_ms:.6f} "
          f"ms per call in a Python loop), plain {plain_ms:.6f} ms; bound "
          f"{bound_ms:.6f} ms by {bound_by} ({ops:.0f} ops from "
          f"{counts['live']} live, {counts['cont']} continued bounces, "
          f"{counts['nodes']} node and {counts['rows']} sphere-row tests, "
          f"{counts['tri_nodes']} triangle-node and {counts['tri_rows']} "
          f"triangle tests; {nbytes} bytes; "
          f"{spec_bound_ms(ops, nbytes):.6f} ms over the spec sheet) on "
          f"{card}")
    return dict(ms=ms, loop_ms=loop_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, live_bounces=counts["live"])


def counted(fn):
    """Run `fn` with every launch count set to 0 just before and read just
    after: (its result, {count name: launches})."""
    import torch

    from raytracing_gpu_tpu_torch.ops import cuda_trace

    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(launches=forward_launches(),
                     record=record_launches(),
                     record_chunk=cuda_trace.Tracer.record_chunk_launches,
                     ray=cuda_trace.Tracer.ray_launches,
                     hit=cuda_trace.Tracer.hit_launches)


def forward_launches() -> int:
    """Launches of the forward kernel, on one wave or on a whole chunk."""
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    return cuda_trace.Tracer.launches + cuda_trace.Tracer.chunk_launches


def record_launches() -> int:
    """Launches of the record kernel on camera rays, on one wave or on a
    group of a training chunk's waves."""
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    return (cuda_trace.Tracer.record_launches
            + cuda_trace.Tracer.record_chunk_launches)


def reset_counts() -> None:
    """Every kernel launch count to 0."""
    from raytracing_gpu_tpu_torch.ops import cuda_trace
    from raytracing_gpu_tpu_torch.utils import roofline

    cuda_trace.reset_launch_counts()
    roofline.launches = 0


def big_scene1_phases(dev, card: str, base: int, png: str) -> tuple:
    """Phases 18-21 (big_scene1's kernels, its megakernel route, BASELINE
    config 2 on the regen route, the regen chunk against its golden), after
    phase 4 set `Ceilings`.  Returns the megakernel route's numbers and the
    hit kernel's row of the kernels line."""
    import numpy as np
    import torch

    from raytracing_gpu_tpu_torch import (RenderSettings, compile_renderer,
                                         render, render_linear)
    from raytracing_gpu_tpu_torch.engine import film
    from raytracing_gpu_tpu_torch.engine.wavefront import (
        compile_regen_renderer)
    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    png_dir = os.path.dirname(os.path.abspath(png))
    # ---- 18. big_scene1: the sphere-BVH forward kernel and the hit kernel
    bsd = scenes.get(BIG)
    btr = cuda_trace.Tracer(bsd.scene, dev)
    with Phase("18 big_scene1 kernels"):
        check_scene_kernel(btr, bsd, base, BIG)
        g = np.load(os.path.join(DATA, f"{BIG}_32.npz"))
        gst = golden_settings(g)
        gchunk = compile_renderer(bsd.scene, bsd.camera, gst, dev)
        gcmp = golden_cmp(gchunk(int(g["base"])), torch.from_numpy(g["sums"]))
        print(f"[kernel-vs-jax-golden] {BIG} {gst.image_width}x"
              f"{gst.image_height} 2spp depth {gst.max_depth} "
              f"({gchunk.engine_name}): {gcmp}")
        if not (gcmp["ok"] and gchunk.engine_name == "megakernel"):
            raise AssertionError(f"{BIG}: kernel disagrees with the JAX "
                                 "golden")
        hg = np.load(os.path.join(DATA, f"{BIG}_hit.npz"))
        for b in range(2):
            got = btr.hit(*(torch.from_numpy(np.array(hg[f"{k}{b}"])).to(dev)
                            for k in ("o", "d", "tm", "alive")))
            hres = cuda_trace.hit_agreement(got, [hg[f"{k}{b}"] for k in (
                "packed", "p", "u", "v", "normal")])
            print(f"[hit-vs-jax-golden] {BIG} 4096 rays, bounce {b}: {hres}")
            if not (hres["packed_equal"] and hres["within_limits"]
                    and hres["frac_close"] >= 0.99):
                raise AssertionError("hit kernel disagrees with the Pallas "
                                     "hit golden")
        for name in (BIG, "first", "cornell_box"):
            hsd = scenes.get(name)
            htr = btr if name == BIG else cuda_trace.Tracer(hsd.scene, dev)
            rays = camera_rays(hsd, HIT_RAYS, 71, dev)
            hit_vs_plain(htr, rays, f"{name} {HIT_RAYS} camera rays")
            rays = scattered_rays(hsd, htr, rays, 72)
            hit_vs_plain(htr, rays, f"{name} {HIT_RAYS} rays, one bounce on")
        rays = camera_rays(bsd, PARTIAL_HIT, 73, dev)
        hit_every_lane(btr, rays, f"{BIG} {PARTIAL_HIT} camera rays")
        hit_every_lane(btr, scattered_rays(bsd, btr, rays, 74),
                       f"{BIG} {PARTIAL_HIT} rays, one bounce on")

    # ---- 19. big_scene1 on the megakernel route; the routes agree ----
    with Phase("19 big_scene1 megakernel route"):
        width, spp, chunks, depth = BIG_MEGAKERNEL
        mst = RenderSettings(image_width=width, aspect_ratio=bsd.aspect,
                             spp_per_chunk=spp, num_chunks=chunks,
                             max_depth=depth, ray_batch=65536)
        if compile_renderer(bsd.scene, bsd.camera, mst,
                            dev).engine_name != "megakernel":
            raise AssertionError("big_scene1 below 16 spp per chunk must "
                                 "take the megakernel")
        png = os.path.join(png_dir, f"chip_smoke_{BIG}_megakernel_{width}.png")
        big_mega = render_counted(bsd, mst, dev, card,
                                  f"{BIG} (megakernel route)", png)
        big_mega.update(time_wave(btr, bsd, mst, base, card,
                                  f"{BIG} (megakernel route)"))
        print(f"[{BIG} megakernel] {big_mega}")
        width, spp, depth = ROUTES_AGREE
        ast = RenderSettings(image_width=width, aspect_ratio=bsd.aspect,
                             spp_per_chunk=spp, num_chunks=1,
                             max_depth=depth, ray_batch=65536)
        regen_img = render_linear(bsd.scene, bsd.camera, ast, seed=1,
                                  device=dev)
        mega_img = render_linear(bsd.scene, bsd.camera,
                                 ast.with_(spp_per_chunk=spp // 2,
                                           num_chunks=2), seed=2, device=dev)
        z = z_scores(regen_img.reshape(-1, 3), mega_img.reshape(-1, 3))
        print(f"[routes] {BIG} {width}x{ast.image_height} {spp}spp depth "
              f"{depth}: regen mean {regen_img.mean(axis=(0, 1))}, megakernel "
              f"mean {mega_img.mean(axis=(0, 1))}, z {z}")
        if not (np.abs(z) < Z_LIMIT).all():
            raise AssertionError("the regen and megakernel routes disagree")

    # ---- 20. BASELINE config 2 on the regen route ----
    with Phase("20 BASELINE config 2"):
        width, spp, chunks, depth = CONFIG2
        c2 = RenderSettings(image_width=width, aspect_ratio=bsd.aspect,
                            spp_per_chunk=spp, num_chunks=chunks,
                            max_depth=depth, ray_batch=65536)
        engine = compile_renderer(bsd.scene, bsd.camera, c2, dev).engine_name
        if engine != "regen":
            raise AssertionError(f"config 2 took {engine}, not regen")
        render(bsd.scene, bsd.camera, c2.with_(image_width=160, num_chunks=1),
               device=dev)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        img2 = render(bsd.scene, bsd.camera, c2, device=dev)
        wall2 = time.perf_counter() - t0
        steps = cuda_trace.Tracer.hit_launches
        stray = forward_launches() + record_launches()
        rays2 = c2.num_pixels * c2.rays_per_pixel
        mrays2 = rays2 / wall2 / 1e6
        print(f"[main] render {BIG} (config 2, engine {engine}) {width}x"
              f"{c2.image_height} {c2.rays_per_pixel}spp depth {depth}: "
              f"{wall2:.6f} s, {mrays2:.6f} Mrays/s, hit launches {steps} "
              f"(one per step, {steps / chunks:.1f} per chunk, each with one "
              f"host read), host time per step {wall2 * 1e3 / steps:.6f} ms, "
              f"megakernel launches {stray} on {card}")
        if steps == 0 or stray != 0:
            raise AssertionError(f"config 2: {steps} hit and {stray} "
                                 "megakernel launches")
        if (img2.shape != (c2.image_height, width, 3)
                or not np.isfinite(img2).all()
                or not 0.05 < float(img2.mean()) < 0.999):
            raise AssertionError(f"config 2: bad image {img2.shape}, mean "
                                 f"{img2.mean()}")
        png = os.path.join(png_dir, f"chip_smoke_{BIG}_{width}.png")
        film.write_png(png, img2)
        print(f"[main] config 2 image mean {img2.mean():.6f} -> {png}")
        prof2 = device_busy(lambda: render(bsd.scene, bsd.camera, c2,
                                           device=dev))
        busy2 = prof2["device_ms"] / (wall2 * 1e3)
        top2 = sorted(prof2["by_kernel"].items(), key=lambda kv: -kv[1][0])
        print(f"[main] config 2 profiled repeat: device "
              f"{prof2['device_ms']:.3f} ms, wall {prof2['wall_ms']:.3f} ms, "
              f"profiler {prof2['profiler_s']:.3f} s around it; top kernels "
              f"(ms, count) {top2[:14]}")
        print(f"[main] config 2 device busy share of the counted render: "
              f"{busy2:.6f} ({prof2['device_ms']:.3f} ms of device time in "
              f"{wall2 * 1e3:.3f} ms) on {card}")

        hrays, (cstats,), _ = capture_step(bsd, c2.with_(num_chunks=1), dev,
                                           [base])
        hcmp = hit_vs_plain(btr, hrays, f"{BIG} regen step {CAPTURE_STEP} "
                            f"({int(hrays[3].sum())} of {HIT_RAYS} live)")
        hit_launch = btr.bind_hit()
        hit_ms = event_ms(lambda r: hit_launch(*hrays), reps=50,
                          hold_device=True)
        hit_loop_ms = event_ms(lambda r: hit_launch(*hrays), reps=50)
        hit_plain_ms = event_ms(lambda r: cuda_trace.hit_reference(
            btr.bake, *hrays), reps=3)
        t_walk = time.perf_counter()
        h_ops, h_counts = hit_ops(btr.bake, hrays)
        t_walk = time.perf_counter() - t_walk
        h_bytes = hit_bytes(btr, HIT_RAYS, h_counts)
        hit_bound_ms, hit_bound_by = bound(h_ops, h_bytes)
        print(f"[time] rt_hit on {BIG} regen step {CAPTURE_STEP} of a chunk "
              f"({cstats}), {HIT_RAYS} rays: kernel {hit_ms:.6f} ms on the "
              f"device ({hit_loop_ms:.6f} ms per call in a Python loop), "
              f"plain {hit_plain_ms:.6f} ms; bound {hit_bound_ms:.6f} ms by "
              f"{hit_bound_by} ({h_ops:.0f} ops, {h_bytes} bytes, {h_counts}, "
              f"counted by the plain walk in {t_walk:.3f} s; "
              f"{spec_bound_ms(h_ops, h_bytes):.6f} ms over the spec sheet) "
              f"on {card}")

    # ---- 21. the regen chunk against the JAX regen golden ----
    with Phase("21 regen vs golden"):
        rg = np.load(os.path.join(DATA, f"{BIG}_regen.npz"))
        rst = golden_settings(rg)
        rchunk = compile_regen_renderer(bsd.scene, bsd.camera, rst,
                                        debug_stats=True, device=dev)
        rsums, rstats = rchunk(20241)
        npix = rst.num_pixels
        z = z_scores(rsums.cpu().numpy()[:npix] / rst.spp_per_chunk,
                     rg["sums"][:npix] / rst.spp_per_chunk)
        step_ratio = rstats["iterations"] / int(rg["iterations"])
        print(f"[regen-vs-jax-golden] {BIG} {rst.image_width}x"
              f"{rst.image_height} {rst.spp_per_chunk}spp depth "
              f"{rst.max_depth}: z {z}, steps {rstats} against JAX's "
              f"{int(rg['iterations'])} and stream {int(rg['stream'])}")
        if not ((np.abs(z) < Z_LIMIT).all() and abs(step_ratio - 1) < 0.1
                and rstats["stream"] == int(rg["stream"])):
            raise AssertionError("the regen chunk disagrees with the JAX "
                                 "regen golden")

    return big_mega, {
        "name": "rt_hit", "route": "cuda", "source": HIT_SOURCE,
        "replaces": HIT_REPLACES, "launches": steps,
        "max_abs_err": hcmp["max_abs_err"], "exact_frac": hcmp["exact_frac"],
        "ms": hit_ms, "plain_ms": hit_plain_ms,
        "bound_ms": hit_bound_ms, "bound_by": hit_bound_by,
        "library_ms": None,
        "loop_ms": hit_loop_ms,
        "config2_mrays_per_s": mrays2,
        "config2_device_busy_share": busy2,
        "config2_steps": steps,
        "config2_host_ms_per_step": wall2 * 1e3 / steps}


def triangle_phases(dev, card: str, base: int, png: str) -> list:
    """Phases 22-26 (the triangle kernels against their plain versions and
    the goldens, their timing, BASELINE config 5 on the regen route, the
    wavefront route, `triangles` on the megakernel route), after phase 4
    set `Ceilings`.  Returns their rows of the kernels line."""
    import numpy as np
    import torch

    from raytracing_gpu_tpu_torch import (Camera, RenderSettings,
                                         SceneBuilder, compile_renderer,
                                         render, render_linear)
    from raytracing_gpu_tpu_torch.engine import film, wavefront
    from raytracing_gpu_tpu_torch.models import probes, scenes
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    png_dir = os.path.dirname(os.path.abspath(png))
    psd = scenes.get("backpack")
    ptr = cuda_trace.Tracer(psd.scene, dev)
    tsd = scenes.get("triangles")
    ttr = cuda_trace.Tracer(tsd.scene, dev)
    print(f"[mesh] backpack bake: {len(ptr.bake.tri_table)} megakernel rows "
          f"in leaves of {cuda_trace.TRI_LEAF_K}, {len(ptr.bake.tri_nodes)} "
          f"nodes; hit tier {len(ptr.bake.tri_geom)} slots, "
          f"{len(ptr.bake.tri_hit_nodes)} nodes; JAX routing predicate "
          f"(tri_stream) {ptr.bake.jax_tri_stream}")

    # ---- 22. the triangle kernels against their plain versions ----
    with Phase("22 triangle kernels"):
        rays = camera_rays(psd, REDUCED_RAYS, 81, dev)
        hit_vs_plain(ptr, rays, f"backpack {REDUCED_RAYS} camera rays "
                     "(reduced wave)")
        rays = scattered_rays(psd, ptr, rays, 82)
        hit_vs_plain(ptr, rays, f"backpack {REDUCED_RAYS} rays, one bounce "
                     "on (reduced wave)")
        check_scene_kernel(ttr, tsd, base, "triangles")
        g = np.load(os.path.join(DATA, "triangles_32.npz"))
        gst = golden_settings(g)
        gchunk = compile_renderer(tsd.scene, tsd.camera, gst, dev)
        gcmp = golden_cmp(gchunk(int(g["base"])), torch.from_numpy(g["sums"]))
        print(f"[kernel-vs-jax-golden] triangles {gst.image_width}x"
              f"{gst.image_height} 2spp depth {gst.max_depth} "
              f"({gchunk.engine_name}): {gcmp}")
        if not (gcmp["ok"] and gchunk.engine_name == "megakernel"):
            raise AssertionError("triangles: kernel disagrees with the JAX "
                                 "golden")
        msd = scenes.backpack_standin((16, 16))
        mtr = cuda_trace.Tracer(msd.scene, dev)
        mg = np.load(os.path.join(DATA, "mesh_hit.npz"))
        perm = mg["perm"]
        if not np.array_equal(mtr.bake.tri_perm, perm):
            raise AssertionError("the small mesh's slot map differs from "
                                 "the golden's")
        for b in range(2):
            got = mtr.hit(*(torch.from_numpy(np.array(mg[f"{k}{b}"])).to(dev)
                            for k in ("o", "d", "tm", "alive")))
            hres = cuda_trace.hit_agreement(got, [mg[f"{k}{b}"] for k in (
                "packed", "p", "u", "v", "normal")])
            tri = ((mg[f"packed{b}"] >> 20) & 1).astype(bool)
            ids = perm[got.slot.cpu().numpy().astype(np.int64)[tri]]
            other = ids != perm[mg[f"slot{b}"].astype(np.int64)[tri]]
            print(f"[hit-vs-jax-golden] small mesh 4096 rays, bounce {b}: "
                  f"{hres}; {int(tri.sum())} triangle winners, "
                  f"{int(other.sum())} with another id (shared edges)")
            if not (hres["packed_equal"] and hres["within_limits"]
                    and hres["frac_close"] >= 0.99 and other.mean() <= 0.01):
                raise AssertionError("hit kernel's triangle tier disagrees "
                                     "with the Pallas hit golden")
        # the warp-cooperative leaves: a partial last warp, sparse lanes,
        # and exact ties (one triangle in two slots of a leaf, another in
        # leaves of its own: the first in the ray's visit order wins)
        rays = camera_rays(psd, PARTIAL_HIT, 85, dev)
        hit_every_lane(ptr, rays, f"backpack {PARTIAL_HIT} camera rays")
        hit_every_lane(ptr, scattered_rays(psd, ptr, rays, 86),
                       f"backpack {PARTIAL_HIT} rays, one bounce on")
        tie_scene, tie_cam, _ = probes.tie_mesh(SceneBuilder, Camera)
        tie = types.SimpleNamespace(scene=tie_scene, camera=tie_cam)
        tie_tr = cuda_trace.Tracer(tie_scene, dev)
        hit_every_lane(tie_tr, camera_rays(tie, PARTIAL_HIT, 87, dev),
                       f"tie scene {PARTIAL_HIT} camera rays")
        waves_every_lane(tie, tie_tr, 450, 800, 8,
                         cuda_trace.wave_seed(base, 0, 5), "tie scene")

    # ---- 23. timing at full size ----
    with Phase("23 triangle kernels timed"):
        width, spp, chunks, depth = CONFIG5
        c5 = RenderSettings(image_width=width, aspect_ratio=CONFIG5_ASPECT,
                            spp_per_chunk=spp, num_chunks=chunks,
                            max_depth=depth, ray_batch=CONFIG5_RAY_BATCH)
        # config 5's chunks at the seeds render() draws (phase 24 renders
        # them), for the step count and a steady-state step's rays
        hrays, c5_stats, c5_launches = capture_step(psd, c5, dev,
                                                    render_bases(c5))
        c5_steps = sum(x["iterations"] for x in c5_stats)
        print(f"[regen] config 5 chunks through debug_stats: {c5_stats}, "
              f"{c5_steps} steps, {c5_launches} hit launches")
        if c5_launches != c5_steps:
            raise AssertionError(f"config 5: {c5_launches} hit launches for "
                                 f"{c5_steps} regen steps")
        hit_n = len(hrays[3])
        hcmp = hit_vs_plain(ptr, hrays, f"backpack regen step {CAPTURE_STEP} "
                            f"({int(hrays[3].sum())} of {hit_n} live)")
        hit_launch = ptr.bind_hit()
        hit_ms = event_ms(lambda r: hit_launch(*hrays), reps=50,
                          hold_device=True)
        hit_loop_ms = event_ms(lambda r: hit_launch(*hrays), reps=50)
        hit_plain_ms = event_ms(lambda r: cuda_trace.hit_reference(
            ptr.bake, *hrays), reps=1)
        h_ops, h_counts = hit_ops(ptr.bake, hrays)
        h_bytes = hit_bytes(ptr, hit_n, h_counts)
        hit_bound_ms, hit_bound_by = bound(h_ops, h_bytes)
        print(f"[time] rt_hit (triangle tier) on backpack regen step "
              f"{CAPTURE_STEP} of config 5's first {spp}-spp chunk "
              f"({c5_stats[0]}), {hit_n} rays: kernel {hit_ms:.6f} ms on "
              f"the "
              f"device ({hit_loop_ms:.6f} ms per call in a Python loop), "
              f"plain {hit_plain_ms:.6f} ms; bound {hit_bound_ms:.6f} ms by "
              f"{hit_bound_by} ({h_ops:.0f} ops, {h_bytes} bytes, "
              f"{h_counts}; {spec_bound_ms(h_ops, h_bytes):.6f} ms over the "
              f"spec sheet) on {card}")
        # the 1d-t wave keeps its 65,536 rays, the wave PERF.md tracks
        mst = c5.with_(spp_per_chunk=1, num_chunks=1, ray_batch=65536)
        # its plain walk takes 4-9 s a call: timed once
        mesh_wave = time_wave(ptr, psd, mst, base, card,
                              "backpack (triangle megakernel)", MESH_WAVE,
                              plain_reps=1)
        print(f"[backpack megakernel wave] {mesh_wave}")

    # ---- 24. BASELINE config 5 on the regen route ----
    with Phase("24 BASELINE config 5"):
        engine = compile_renderer(psd.scene, psd.camera, c5, dev).engine_name
        if engine != "regen":
            raise AssertionError(f"config 5 took {engine}, not regen")
        render(psd.scene, psd.camera, c5.with_(image_width=160, num_chunks=1,
                                               spp_per_chunk=16),
               device=dev)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        img5 = render(psd.scene, psd.camera, c5, device=dev)
        wall5 = time.perf_counter() - t0
        steps5 = cuda_trace.Tracer.hit_launches
        stray = forward_launches() + record_launches()
        peak5 = torch.cuda.max_memory_allocated() / 2**20
        rays5 = c5.num_pixels * c5.rays_per_pixel
        mrays5 = rays5 / wall5 / 1e6
        print(f"[main] render backpack (config 5, engine {engine}) {width}x"
              f"{c5.image_height} {c5.rays_per_pixel}spp depth {depth}: "
              f"{wall5:.6f} s, {mrays5:.6f} Mrays/s, hit launches {steps5} "
              f"for {c5_steps} regen steps ({steps5 / chunks:.1f} per "
              f"chunk, each with one host read), host time per step "
              f"{wall5 * 1e3 / max(steps5, 1):.6f} ms, megakernel launches "
              f"{stray}, peak allocated {peak5:.3f} MiB on {card}")
        if steps5 == 0 or steps5 != c5_steps or stray != 0:
            raise AssertionError(f"config 5: {steps5} hit launches for "
                                 f"{c5_steps} steps, {stray} megakernel "
                                 "launches")
        if (img5.shape != (c5.image_height, width, 3)
                or not np.isfinite(img5).all()
                or not 0.05 < float(img5.mean()) < 0.999):
            raise AssertionError(f"config 5: bad image {img5.shape}, mean "
                                 f"{img5.mean()}")
        png5 = os.path.join(png_dir, f"chip_smoke_backpack_{width}.png")
        film.write_png(png5, img5)
        print(f"[main] config 5 image mean {img5.mean():.6f} -> {png5}")
        # the busy share of a bounded sub-run: one 16-spp chunk
        sub = c5.with_(spp_per_chunk=CONFIG5_PROFILED_SPP, num_chunks=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(psd.scene, psd.camera, sub, device=dev)
        sub_wall = time.perf_counter() - t0
        prof5 = device_busy(lambda: render(psd.scene, psd.camera, sub,
                                           device=dev))
        busy5 = prof5["device_ms"] / (sub_wall * 1e3)
        top5 = sorted(prof5["by_kernel"].items(), key=lambda kv: -kv[1][0])
        print(f"[main] config 5 bounded sub-run (one {CONFIG5_PROFILED_SPP}"
              f"-spp chunk, not the counted render), profiled with CUDA "
              f"activity only: device {prof5['device_ms']:.3f} ms, wall "
              f"{prof5['wall_ms']:.3f} ms profiled and {sub_wall * 1e3:.3f} "
              f"ms unprofiled, profiler {prof5['profiler_s']:.3f} s around "
              f"it; top kernels (ms, count) {top5[:14]}")
        print(f"[main] config 5 device busy share of the sub-run: "
              f"{busy5:.6f} on {card}")
        # config 5-rr: the same shape with russian roulette from bounce 2
        c5rr = c5.with_(rr_start=CONFIG5_RR_START)
        reset_counts()
        t0 = time.perf_counter()
        img_rr = render(psd.scene, psd.camera, c5rr, device=dev)
        wall_rr = time.perf_counter() - t0
        steps_rr = cuda_trace.Tracer.hit_launches
        stray = forward_launches() + record_launches()
        mrays_rr = rays5 / wall_rr / 1e6
        print(f"[main] render backpack (config 5-rr, rr_start "
              f"{CONFIG5_RR_START}) {width}x{c5.image_height} "
              f"{c5.rays_per_pixel}spp depth {depth}: {wall_rr:.6f} s, "
              f"{mrays_rr:.6f} Mrays/s, {steps_rr} steps (hit launches), "
              f"host time per step {wall_rr * 1e3 / max(steps_rr, 1):.6f} ms, "
              f"image mean {img_rr.mean():.6f} ({img5.mean():.6f} without), "
              f"megakernel launches {stray} on {card}")
        if (steps_rr == 0 or stray != 0 or not np.isfinite(img_rr).all()
                or not 0.05 < float(img_rr.mean()) < 0.999):
            raise AssertionError("config 5-rr is off")

    # ---- 25. the wavefront route ----
    with Phase("25 wavefront route"):
        width, spp, chunks, depth = WAVEFRONT_ROUTE
        wst = RenderSettings(image_width=width, aspect_ratio=CONFIG5_ASPECT,
                             spp_per_chunk=spp, num_chunks=chunks,
                             max_depth=depth, ray_batch=65536)
        engine = compile_renderer(psd.scene, psd.camera, wst,
                                  dev).engine_name
        if engine != "wavefront":
            raise AssertionError(f"backpack at {spp} spp took {engine}")
        render(psd.scene, psd.camera, wst.with_(image_width=160),
               device=dev)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        wimg = render(psd.scene, psd.camera, wst, device=dev)
        wwall = time.perf_counter() - t0
        wlaunches = cuda_trace.Tracer.hit_launches
        stray = forward_launches() + record_launches()
        # the bounces of the same chunk, through debug_stats
        _, wstats = wavefront.compile_wavefront_renderer(
            psd.scene, psd.camera, wst, debug_stats=True,
            device=dev)(render_bases(wst)[0])
        bounces = wstats["iterations"]
        wrays = wst.num_pixels * wst.rays_per_pixel
        print(f"[main] render backpack (engine {engine}) {width}x"
              f"{wst.image_height} {wst.rays_per_pixel}spp depth {depth}: "
              f"{wwall:.6f} s, {wrays / wwall / 1e6:.6f} Mrays/s, hit "
              f"launches {wlaunches} for {bounces} bounces, megakernel "
              f"launches {stray} on {card}")
        if (wlaunches == 0 or wlaunches != bounces or stray != 0
                or not np.isfinite(wimg).all()
                or not 0.05 < float(wimg.mean()) < 0.999):
            raise AssertionError("the wavefront route is off")
        width, spp, depth = WAVEFRONT_AGREE
        ast = RenderSettings(image_width=width, aspect_ratio=CONFIG5_ASPECT,
                             spp_per_chunk=spp, num_chunks=1,
                             max_depth=depth, ray_batch=65536)
        regen_img = render_linear(psd.scene, psd.camera, ast, seed=1,
                                  device=dev)
        wave_img = render_linear(psd.scene, psd.camera,
                                 ast.with_(spp_per_chunk=spp // 2,
                                           num_chunks=2), seed=2, device=dev)
        z = z_scores(regen_img.reshape(-1, 3), wave_img.reshape(-1, 3))
        print(f"[routes] backpack {width}x{ast.image_height} {spp}spp depth "
              f"{depth}: regen mean {regen_img.mean(axis=(0, 1))}, wavefront "
              f"mean {wave_img.mean(axis=(0, 1))}, z {z}")
        if not (np.abs(z) < Z_LIMIT).all():
            raise AssertionError("the regen and wavefront routes disagree")

    # ---- 26. triangles on the megakernel route ----
    with Phase("26 triangles megakernel route"):
        width, spp, chunks, depth = TRIANGLES_ROUTE
        tst = RenderSettings(image_width=width, aspect_ratio=tsd.aspect,
                             spp_per_chunk=spp, num_chunks=chunks,
                             max_depth=depth, ray_batch=65536)
        tri_render = render_counted(
            tsd, tst, dev, card, "triangles (megakernel route)",
            os.path.join(png_dir, f"chip_smoke_triangles_{width}.png"))
        tri_render.update(time_wave(ttr, tsd, tst, base, card,
                                    "triangles (megakernel route)"))
        print(f"[triangles megakernel] {tri_render}")

    return [{
        "name": "megakernel_fwd<tri_bvh>", "route": "cuda",
        "source": TRI_SOURCE, "replaces": REPLACES,
        "launches": tri_render["launches"],
        "max_abs_err": mesh_wave["max_abs_err"],
        "exact_frac": mesh_wave["exact_frac"],
        "ms": mesh_wave["ms"], "plain_ms": mesh_wave["plain_ms"],
        "bound_ms": mesh_wave["bound_ms"], "bound_by": mesh_wave["bound_by"],
        "library_ms": None,
        "loop_ms": mesh_wave["loop_ms"],
        "triangles_render_mrays_per_s": tri_render["mrays_per_s"],
        "triangles_wave_ms": tri_render["ms"]}, {
        "name": "rt_hit<tri>", "route": "cuda", "source": HIT_SOURCE,
        "replaces": HIT_REPLACES, "launches": steps5,
        "max_abs_err": hcmp["max_abs_err"], "exact_frac": hcmp["exact_frac"],
        "ms": hit_ms, "plain_ms": hit_plain_ms,
        "bound_ms": hit_bound_ms, "bound_by": hit_bound_by,
        "library_ms": None,
        "loop_ms": hit_loop_ms,
        "config5_mrays_per_s": mrays5,
        "config5_steps": steps5,
        "config5_host_ms_per_step": wall5 * 1e3 / steps5,
        "config5_peak_allocated_mib": peak5,
        "config5_subrun_device_busy_share": busy5,
        "config5_rr_mrays_per_s": mrays_rr, "config5_rr_steps": steps_rr,
        "wavefront_route_mrays_per_s": wrays / wwall / 1e6}]


def training_phases(dev, card: str, base: int) -> tuple:
    """Phases 27-32 (kernel 1b's hit-point planes and BVH walks and kernel
    1c's ray planes against their plain versions and the goldens, the fused
    chunk with hit points, config 2's scene in training, the record-walk
    route, `bench_all.py`'s mesh-grad row), after phase 4 set `Ceilings`.
    Returns their rows of the kernels line, and the mesh-grad row's rates
    for the row of `rt_hit<tri>`, the one kernel that route launches."""
    import numpy as np
    import torch

    import bench_torch
    from raytracing_gpu_tpu_torch import RenderSettings
    from raytracing_gpu_tpu_torch.engine import diff, fused_diff, render
    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    tracers = {n: (scenes.get(n), cuda_trace.Tracer(scenes.get(n).scene, dev))
               for n in REC_SCENES + ("cornell_box", "backpack")}

    # ---- 27. kernel 1b rest against its plain version, then the goldens
    with Phase("27 record p and BVH walks"):
        for name in REC_SCENES:
            sd, tr = tracers[name]
            got, want = [], []
            for s in range(4):
                seed = cuda_trace.wave_seed(base, s, 0)
                got.append(tr.walk_packed_pixels(sd.camera, 64, 64, 0, 4096,
                                                 seed, max_depth=8))
                want.append(cuda_trace.walk_packed_pixels_reference(
                    tr.bake, sd.camera, 64, 64, 0, 4096, seed, 8,
                    device=dev))
            torch.cuda.synchronize()
            record_vs_plain([torch.stack(x) for x in zip(*got)],
                            [torch.stack(x) for x in zip(*want)],
                            f"{name} 64x64 4spp depth 8")
        psd, ptr = tracers["backpack"]
        seed = cuda_trace.wave_seed(base, 0, MESH_WAVE)
        record_vs_plain(
            ptr.walk_packed_pixels(psd.camera, 600, 800, 3 * 65536,
                                   REDUCED_RAYS, seed, max_depth=8),
            cuda_trace.walk_packed_pixels_reference(
                ptr.bake, psd.camera, 600, 800, 3 * 65536, REDUCED_RAYS,
                seed, 8, device=dev),
            f"backpack 800x600 {REDUCED_RAYS} rays depth 8 (reduced wave)")
        for name in REC_SCENES:
            sd, tr = tracers[name]
            g = np.load(os.path.join(DATA, f"{name}_rec32.npz"))
            gst = golden_settings(g)
            gh, gw, gb = gst.image_height, gst.image_width, gst.ray_batch
            waves = [(bid * gb, gb, cuda_trace.wave_seed(int(g["base"]), s,
                                                          bid))
                     for s in range(gst.spp_per_chunk)
                     for bid in range(-(-gh * gw // gb))]
            planes = [tr.walk_packed_pixels(sd.camera, gh, gw, *wv,
                                            gst.max_depth, gst.t_min)
                      for wv in waves]
            got = torch.stack([x[0] for x in planes])
            same = None
            if "lens_cs" in g:  # lanes whose lens angle rounds as XLA's
                same = np.stack([
                    (cuda_trace.lens_cos_sin(wseed, n, dev).cpu().numpy()
                     == g["lens_cs"][i]).all(0)
                    for i, (_, n, wseed) in enumerate(waves)])
            jcmp = cuda_trace.record_agreement(got, g["planes"], same)
            pcmp = (cuda_trace.p_agreement(got, g["planes"], torch.stack(
                [torch.stack(x[1:]) for x in planes]), g["p"])
                if tr.need_p else {"hit_rule": True})
            print(f"[record-vs-jax-golden] {name} {gw}x{gh} 2spp depth "
                  f"{gst.max_depth}: {jcmp}; hit points {pcmp}; lanes with "
                  f"XLA's lens rounding "
                  f"{'all' if same is None else float(same.mean())}")
            if not (jcmp["first_bounce"] and jcmp["lane_frac"] >= LANE_FLOOR
                    and pcmp["hit_rule"]):
                raise AssertionError(f"{name}: record kernel disagrees with "
                                     "the JAX golden")
        # the warp-cooperative sphere leaves on every lane: big_scene1's
        # training shape with a partial last warp, all three entries
        bsd, btr = tracers["big_scene1"]
        width, _, _, depth, _ = BIG_TRAIN
        waves_every_lane(bsd, btr, width * 9 // 16, width, depth,
                         cuda_trace.wave_seed(base, 0, 6), "big_scene1")

    # ---- 28. kernel 1c against its plain version, then the goldens ----
    with Phase("28 ray planes"):
        for name in ("cornell_box", "big_scene1"):
            sd, tr = tracers[name]
            o, d, tm, _ = camera_rays(sd, RAY_WAVE, 83, dev)
            record_vs_plain(tr.walk_packed(o, d, tm, 84, max_depth=8),
                            cuda_trace.walk_packed_reference(
                                tr.bake, o, d, tm, 84, 8),
                            f"{name} walk_packed {RAY_WAVE} rays depth 8")
            for rr in (0, 2):
                cmp = compare(tr(o, d, tm, 84, max_depth=8, rr_start=rr),
                              cuda_trace.trace_rays_reference(
                                  tr.bake, o, d, tm, 84, 8, rr_start=rr), 8)
                print(f"[kernel-vs-plain] {name} __call__ {RAY_WAVE} rays "
                      f"depth 8 rr_start {rr}: {cmp}")
                if not cmp["ok"]:
                    raise AssertionError(f"{name}: ray-plane forward kernel "
                                         "disagrees with plain")
            g = np.load(os.path.join(DATA, f"{name}_rays.npz"))
            rays = [torch.from_numpy(np.ascontiguousarray(g[k])).to(dev)
                    for k in ("o", "d", "tm")]
            gd, gs = int(g["max_depth"]), int(g["seed"])
            planes = tr.walk_packed(*rays, gs, max_depth=gd)
            jcmp = cuda_trace.record_agreement(planes[0], g["planes"])
            pcmp = (cuda_trace.p_agreement(planes[0], g["planes"],
                                           torch.stack(planes[1:]), g["p"])
                    if tr.need_p else {"hit_rule": True})
            rcmp = golden_cmp(tr(*rays, gs, max_depth=gd),
                              torch.from_numpy(g["radiance"]))
            print(f"[rays-vs-jax-golden] {name} 512 rays depth {gd}: planes "
                  f"{jcmp}; hit points {pcmp}; radiance {rcmp}")
            if not (jcmp["first_bounce"] and jcmp["lane_frac"] >= LANE_FLOOR
                    and pcmp["hit_rule"] and rcmp["ok"]):
                raise AssertionError(f"{name}: ray-plane kernels disagree "
                                     "with the JAX golden")
        # the forward ray-plane kernel on a main path: a chunk of the
        # Cornell box at 512x512, 4 spp, depth 8 over torch-drawn rays
        csd, ctr = tracers["cornell_box"]
        cst = RenderSettings(image_width=512, aspect_ratio=1.0,
                             spp_per_chunk=4, num_chunks=1, max_depth=8,
                             ray_batch=65536)
        trace_rays = ctr.bind_trace_rays(cst.max_depth, cst.t_min)
        sums, rcounts = counted(lambda: render.chunk_sums(
            csd.scene, csd.camera, cst, base,
            lambda _s, o, d, tm, seed: trace_rays(o, d, tm, seed), dev))
        fwd_ray_launches = rcounts["ray"]
        expected = cst.spp_per_chunk * (cst.num_pixels // cst.ray_batch)
        print(f"[main] chunk_sums over __call__, cornell_box 512x512 4spp "
              f"depth 8: launches {rcounts} (expected {expected} ray-plane)")
        mean = float(sums.mean()) / cst.spp_per_chunk
        if (fwd_ray_launches != expected or rcounts["launches"]
                or rcounts["record"] or rcounts["hit"]
                or not bool(torch.isfinite(sums).all()) or not mean > 0.01):
            raise AssertionError("the ray-plane forward chunk is off")
        o, d, tm, seed = render.wave_rays(csd.camera.to(dev), cst, 65536,
                                          65536, 11, dev)
        counts = {}
        fwd_cmp = compare(trace_rays(o, d, tm, seed),
                          cuda_trace.trace_rays_reference(
                              ctr.bake, o, d, tm, seed, 8, counts=counts), 8)
        if not fwd_cmp["ok"]:
            raise AssertionError("ray-plane forward wave disagrees")
        fwd_ops = wave_ops(ctr.bake, counts, 65536) - 65536 * OPS_CAMERA
        fwd_time = time_record(
            "__call__ (kernel 1c, forward) on a cornell_box wave of 65536 "
            "torch-drawn rays, depth 8", card,
            lambda r: trace_rays(o, d, tm, seed + r),
            lambda r: cuda_trace.trace_rays_reference(ctr.bake, o, d, tm,
                                                      seed + r, 8),
            lambda: counts, lambda c: fwd_ops,
            lambda c: (RAY_BYTES + 12) * 65536 + table_bytes(ctr))
        fwd_time.update(max_abs_err=fwd_cmp["max_abs_err"],
                        exact_frac=fwd_cmp["exact_frac"])

    # ---- 29. the fused chunk with hit points on the card ----
    with Phase("29 fused chunk with p"):
        sd, tr = tracers["two_spheres"]
        g = np.load(os.path.join(DATA, "two_spheres_rec32.npz"))
        gst = golden_settings(g)
        gh, gw, gb = gst.image_height, gst.image_width, gst.ray_batch
        gbase = int(g["base"])
        waves = [(bid * gb, gb, cuda_trace.wave_seed(gbase, s, bid))
                 for s in range(gst.spp_per_chunk)
                 for bid in range(-(-gh * gw // gb))]
        golden_planes = {wv: (torch.from_numpy(g["planes"][i]).to(dev),
                              *torch.from_numpy(g["p"][i]).to(dev).unbind(0))
                         for i, wv in enumerate(waves)}
        params = diff.get_params(sd.scene, dev)

        def value_and_grad(chunk):
            out = chunk(params, gbase)
            _, grads = diff.value_and_grad(
                params, lambda p: chunk(p, gbase),
                torch.full_like(out, float(g["target"])))
            return out.detach(), grads

        want_grads = {k: g[f"grad_{k}"] for k in diff.PARAM_KEYS}
        on_golden = value_and_grad(fused_diff.fused_chunk_from_walk(
            sd.scene, lambda pb, n, seed: golden_planes[(pb, n, seed)], gst,
            device=dev))
        kernel = value_and_grad(fused_diff.compile_fused_param_renderer(
            sd.scene, sd.camera, gst, device=dev))
        plain = value_and_grad(fused_diff.fused_chunk_from_walk(
            sd.scene,
            lambda pb, n, seed: cuda_trace.walk_packed_pixels_reference(
                tr.bake, sd.camera, gh, gw, pb, n, seed, gst.max_depth,
                gst.t_min, dev), gst, device=dev))
        for what, (out, grads), (ref, ref_grads) in (
                ("golden planes vs jax-golden", on_golden,
                 (torch.from_numpy(g["primal"]), want_grads)),
                ("kernel vs plain-on-card", kernel, plain)):
            pcmp = compare(out, ref, gst.max_depth)
            if what.startswith("golden"):
                pcmp["ok"] = bool(torch.allclose(out.cpu(), ref, rtol=2e-4,
                                                 atol=1e-7))
            gcmp = grad_cmp(grads, ref_grads)
            print(f"[fused-with-p] two_spheres {gw}x{gh} 2spp depth "
                  f"{gst.max_depth}, {what}: primal {pcmp}, gradients "
                  f"{gcmp}")
            if not (pcmp["ok"] and gcmp["ok"]):
                raise AssertionError(f"fused chunk with p: {what} disagree")

    # ---- 30. config 2's scene in training ----
    with Phase("30 big_scene1 training"):
        bsd, btr = tracers["big_scene1"]
        width, spp, chunks, depth, batch = BIG_TRAIN
        bst = RenderSettings(image_width=width, aspect_ratio=bsd.aspect,
                             spp_per_chunk=spp, num_chunks=chunks,
                             max_depth=depth, ray_batch=batch)
        bchunk = fused_diff.compile_fused_param_renderer(bsd.scene,
                                                         bsd.camera, bst,
                                                         device=dev)
        bparams = diff.get_params(bsd.scene, dev)
        gen = torch.Generator().manual_seed(bench_torch.SEED)
        bbases = [cuda_trace.chunk_seed(gen) for _ in range(chunks)]
        nb = -(-bst.num_pixels // batch)
        target = torch.zeros((nb * batch, 3), dtype=torch.float32,
                             device=dev)
        warm = fused_diff.compile_fused_param_renderer(
            bsd.scene, bsd.camera, bst.with_(image_width=64, spp_per_chunk=1),
            device=dev)
        bench_torch.train_renders(warm, bparams, torch.zeros_like(
            warm(bparams, 1)), [1])  # warm-up, at a small width
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (loss, grads), bcounts = counted(lambda: bench_torch.train_renders(
            bchunk, bparams, target, bbases))
        bwall = time.perf_counter() - t0
        bpeak = torch.cuda.max_memory_allocated() / 2**30
        # one record chunk launch a chunk forward and one backward (planes
        # not saved); before the chunk launch, one a (sample, wave) each
        # way: 2 x 2 x 16 x 11 = 704
        expected = chunks
        brays = bst.num_pixels * bst.rays_per_pixel
        bmrays = brays / bwall / 1e6
        print(f"[train] fwd+bwd big_scene1 {width}x{bst.image_height} "
              f"{bst.rays_per_pixel}spp ({chunks} x {spp}) depth {depth}, "
              f"ray_batch {batch}, save_planes {bchunk.save_planes}: "
              f"{bwall:.6f} s, {bmrays:.6f} Mrays/s, launches {bcounts} "
              f"(expected {expected} record chunk launches forward and as "
              f"many backward, for {2 * chunks * spp * nb} waves), peak "
              f"allocated {bpeak:.3f} GiB on {card}")
        if (bcounts["record_chunk"] != 2 * expected
                or bcounts["record"] != 2 * expected or bchunk.save_planes
                or bcounts["launches"] or bcounts["hit"] or bcounts["ray"]):
            raise AssertionError(f"big_scene1 training: launches {bcounts}, "
                                 f"expected {2 * expected} record chunk "
                                 "launches")
        if not (bool(torch.isfinite(loss)) and float(loss) > 0.0
                and all(bool(torch.isfinite(v).all())
                        for v in grads.values())
                and float(grads["tex_c1"].abs().max()) > 0.0
                and float(grads["tex_c2"].abs().max()) > 0.0):
            raise AssertionError("big_scene1 training: bad loss or "
                                 "gradients")
        # the busy share of a bounded sub-run: one chunk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bench_torch.train_renders(bchunk, bparams, target, bbases[:1])
        torch.cuda.synchronize()
        sub_wall = time.perf_counter() - t0
        bprof = device_busy(lambda: bench_torch.train_renders(
            bchunk, bparams, target, bbases[:1]))
        bbusy = bprof["device_ms"] / (sub_wall * 1e3)
        top = sorted(bprof["by_kernel"].items(), key=lambda kv: -kv[1][0])
        print(f"[train] big_scene1 one-chunk sub-run: device "
              f"{bprof['device_ms']:.3f} ms in {sub_wall * 1e3:.3f} ms "
              f"unprofiled, busy share {bbusy:.6f}; top kernels (ms, count) "
              f"{top[:12]}")
        # the training wave of the sphere-BVH record kernel, with p
        wave = btr.bind_record(bsd.camera, bst.image_height, width, depth,
                               bst.t_min)
        wseed = cuda_trace.wave_seed(bbases[0], 0, 1)
        bw_cmp = record_vs_plain(
            wave(batch, batch, wseed),
            cuda_trace.walk_packed_pixels_reference(
                btr.bake, bsd.camera, bst.image_height, width, batch, batch,
                wseed, depth, device=dev),
            f"big_scene1 training wave of {batch} rays depth {depth}")
        bw_time = time_record(
            f"megakernel_record (sphere BVH, p) on big_scene1's training "
            f"wave, {batch} rays, depth {depth}", card,
            lambda r: wave(batch, batch, wseed + r),
            lambda r: cuda_trace.walk_packed_pixels_reference(
                btr.bake, bsd.camera, bst.image_height, width, batch, batch,
                wseed + r, depth, device=dev),
            lambda: trace_counts(btr, bsd.camera, bst.image_height, width,
                                 batch, batch, wseed, depth),
            lambda c: record_wave_ops(btr.bake, c, batch, True),
            lambda c: record_wave_bytes(btr, c, batch, depth, False))
        bw_time.update(max_abs_err=bw_cmp["max_abs_err"],
                       exact_frac=bw_cmp["exact_frac"])
        # `triangles` in training: the triangle-BVH record kernel
        tsd, ttr = tracers["triangles"]
        width, spp, chunks, depth, batch = TRI_TRAIN
        tst = RenderSettings(image_width=width, aspect_ratio=tsd.aspect,
                             spp_per_chunk=spp, num_chunks=chunks,
                             max_depth=depth, ray_batch=batch)
        tchunk = fused_diff.compile_fused_param_renderer(tsd.scene,
                                                         tsd.camera, tst,
                                                         device=dev)
        tparams = diff.get_params(tsd.scene, dev)
        ttarget = torch.zeros((-(-tst.num_pixels // batch) * batch, 3),
                              device=dev)
        t0 = time.perf_counter()
        (tloss, tgrads), tcounts = counted(lambda: bench_torch.train_renders(
            tchunk, tparams, ttarget, [base]))
        twall = time.perf_counter() - t0
        # one record chunk launch (planes kept); 16 waves before it
        texpected = 1 if tchunk.save_planes else 2
        print(f"[train] fwd+bwd triangles {width}x{tst.image_height} "
              f"{spp}spp depth {depth}: {twall:.6f} s, launches {tcounts} "
              f"(expected {texpected} record chunk launches, for "
              f"{spp * -(-tst.num_pixels // batch)} waves) on {card}")
        if (tcounts["record_chunk"] != texpected
                or tcounts["record"] != texpected or tcounts["launches"]
                or not tchunk.save_planes
                or not float(tgrads["tex_c1"].abs().max()) > 0.0):
            raise AssertionError("triangles training is off")
        tw = ttr.bind_record(tsd.camera, tst.image_height, width, depth,
                             tst.t_min)
        tw_cmp = record_vs_plain(
            tw(0, batch, wseed),
            cuda_trace.walk_packed_pixels_reference(
                ttr.bake, tsd.camera, tst.image_height, width, 0, batch,
                wseed, depth, device=dev),
            f"triangles wave of {batch} rays depth {depth}")
        tw_time = time_record(
            f"megakernel_record (triangle BVH) on triangles' wave, {batch} "
            f"rays, depth {depth}", card,
            lambda r: tw(0, batch, wseed + r),
            lambda r: cuda_trace.walk_packed_pixels_reference(
                ttr.bake, tsd.camera, tst.image_height, width, 0, batch,
                wseed + r, depth, device=dev),
            lambda: trace_counts(ttr, tsd.camera, tst.image_height, width, 0,
                                 batch, wseed, depth),
            lambda c: record_wave_ops(ttr.bake, c, batch, True),
            lambda c: record_wave_bytes(ttr, c, batch, depth, False))
        tw_time.update(max_abs_err=tw_cmp["max_abs_err"],
                       exact_frac=tw_cmp["exact_frac"])

    # ---- 31. the record-walk route at full width ----
    with Phase("31 record-walk route"):
        width, spp, _, depth, batch = BIG_TRAIN
        wst = bst.with_(num_chunks=1)
        walk_chunk = render.compile_param_renderer(bsd.scene, bsd.camera, wst,
                                                   device=dev)
        if walk_chunk.engine_name != "record-walk":
            raise AssertionError(f"big_scene1 took {walk_chunk.engine_name}")
        t0 = time.perf_counter()
        wsums, wcounts = counted(lambda: walk_chunk(bparams, bbases[0]))
        wwall = time.perf_counter() - t0
        expected = spp * nb
        fused_rays = fused_diff.compile_fused_param_renderer(
            bsd.scene, bsd.camera, wst, gen_rays=False, device=dev)
        same = bool(torch.equal(wsums, fused_rays(bparams, bbases[0])))
        wrays = wst.num_pixels * wst.rays_per_pixel
        print(f"[main] compile_param_renderer big_scene1 (engine "
              f"{walk_chunk.engine_name}) {width}x{wst.image_height} {spp}spp "
              f"depth {depth}, primal: {wwall:.6f} s, "
              f"{wrays / wwall / 1e6:.6f} Mrays/s, launches {wcounts} "
              f"(expected {expected} ray-plane record launches); equal to "
              f"the fused chunk with gen_rays=False {same} on {card}")
        if (wcounts["ray"] != expected or wcounts["record"]
                or wcounts["launches"] or wcounts["hit"] or not same
                or not bool(torch.isfinite(wsums).all())):
            raise AssertionError("the record-walk route is off")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (wloss, wgrads), wgcounts = counted(
            lambda: bench_torch.train_renders(walk_chunk, bparams, target,
                                              bbases[:1]))
        wgwall = time.perf_counter() - t0
        wpeak = torch.cuda.max_memory_allocated() / 2**30
        wexpected = expected * (1 if walk_chunk.save_planes else 2)
        print(f"[main] record-walk route fwd+bwd: {wgwall:.6f} s, "
              f"{wrays / wgwall / 1e6:.6f} Mrays/s, launches {wgcounts} "
              f"(expected {wexpected} ray-plane record launches, "
              f"save_planes {walk_chunk.save_planes}), peak allocated "
              f"{wpeak:.3f} GiB on {card}")
        if (wgcounts["ray"] != wexpected or wgcounts["record"]
                or wgcounts["launches"] or wgcounts["hit"]
                or not bool(torch.isfinite(wloss))
                or not all(bool(torch.isfinite(v).all())
                           for v in wgrads.values())
                or not float(wgrads["tex_c1"].abs().max()) > 0.0
                or not float(wgrads["tex_c2"].abs().max()) > 0.0):
            raise AssertionError("the record-walk route's gradients are off")
        o, d, tm, rseed = render.wave_rays(bsd.camera.to(dev), wst, 0, batch,
                                           cuda_trace.wave_seed(bbases[0], 0,
                                                                0), dev)
        walk_rays = btr.bind_walk_packed(depth, wst.t_min)
        rw_cmp = record_vs_plain(
            walk_rays(o, d, tm, rseed),
            cuda_trace.walk_packed_reference(btr.bake, o, d, tm, rseed,
                                             depth),
            f"big_scene1 first wave of the chunk, {batch} rays")
        rw_time = time_record(
            f"walk_packed (kernel 1c, record) on the first wave of "
            f"big_scene1's {spp}-spp chunk, {batch} rays, depth {depth}",
            card, lambda r: walk_rays(o, d, tm, rseed + r),
            lambda r: cuda_trace.walk_packed_reference(btr.bake, o, d, tm,
                                                       rseed + r, depth),
            lambda: ray_counts(btr, o, d, tm, rseed, depth),
            lambda c: record_wave_ops(btr.bake, c, batch, False),
            lambda c: record_wave_bytes(btr, c, batch, depth, True))
        rw_time.update(max_abs_err=rw_cmp["max_abs_err"],
                       exact_frac=rw_cmp["exact_frac"])

    # ---- 32. bench_all.py's mesh-grad row ----
    with Phase("32 mesh-grad"):
        width, spp, chunks, depth, batch = MESH_GRAD
        mst = RenderSettings(image_width=width, aspect_ratio=CONFIG5_ASPECT,
                             spp_per_chunk=spp, num_chunks=chunks,
                             max_depth=depth, ray_batch=batch)
        mchunk = render.compile_param_renderer(psd.scene, psd.camera, mst,
                                               device=dev, debug_stats=True)
        if mchunk.engine_name != "wavefront-record":
            raise AssertionError(f"backpack took {mchunk.engine_name}")
        mparams = diff.get_params(psd.scene, dev)
        stats = {}

        def mesh_grad():
            def chunk(p):
                sums, st_ = mchunk(p, base)
                stats.update(st_)
                return sums
            return diff.value_and_grad(mparams, chunk, 0.0)

        mesh_grad()  # warm-up
        t0 = time.perf_counter()
        (mloss, mgrads), mcounts = counted(mesh_grad)
        mwall = time.perf_counter() - t0
        mrays = mst.num_pixels * mst.rays_per_pixel
        print(f"[main] mesh-grad: compile_param_renderer backpack (engine "
              f"{mchunk.engine_name}) {width}x{mst.image_height} {spp}spp "
              f"depth {depth}, fwd+bwd: {mwall:.6f} s, "
              f"{mrays / mwall / 1e6:.6f} Mrays/s, launches {mcounts} for "
              f"{stats['iterations']} bounces, tex_c1 gradient "
              f"{mgrads['tex_c1'].cpu().numpy().tolist()} on {card}")
        if (mcounts["hit"] != stats["iterations"] or mcounts["hit"] == 0
                or mcounts["launches"] or mcounts["record"] or mcounts["ray"]
                or not float(mgrads["tex_c1"].abs().max()) > 0.0
                or not bool(torch.isfinite(mloss))):
            raise AssertionError("the mesh-grad row is off")

    return [{
        "name": "megakernel_record<sphere_bvh,p>", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": bcounts["record"], **bw_time, "library_ms": None,
        "train_mrays_per_s": bmrays, "train_peak_allocated_gib": bpeak,
        "train_subrun_device_busy_share": bbusy}, {
        "name": "megakernel_record<tri_bvh>", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": tcounts["record"], **tw_time, "library_ms": None}, {
        "name": "megakernel_record<rays>", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": wcounts["ray"], **rw_time, "library_ms": None,
        "record_walk_mrays_per_s": wrays / wwall / 1e6,
        "record_walk_train_mrays_per_s": wrays / wgwall / 1e6,
        "record_walk_train_peak_allocated_gib": wpeak}, {
        "name": "megakernel_fwd<rays>", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": fwd_ray_launches, **fwd_time, "library_ms": None}], {
        "mesh_grad_mrays_per_s": mrays / mwall / 1e6,
        "mesh_grad_seconds": mwall}


def sphere_uv_ops(scene, plane) -> float:
    """float32 operations of the sphere winners' uv in a record plane: its
    hits whose material only spheres carry, OPS_SPHERE_UV each (the other
    winners' uv carry is left out, so the bound stays a lower bound)."""
    import numpy as np

    sp, others = scene.spheres, set()
    for tbl in (scene.rects, scene.boxes, scene.triangles):
        others |= set(np.asarray(tbl.mat_id)[np.asarray(tbl.active)].tolist())
    only = sorted(set(np.asarray(sp.mat_id)[np.asarray(sp.active)].tolist())
                  - others)
    words = plane.detach().cpu().numpy()
    hit_mats = (words & 0xFFFF)[((words >> 16) & 1) == 1]
    return float(np.isin(hit_mats, only).sum()) * OPS_SPHERE_UV


def image_phases(dev, card: str, base: int, c5_steps: int) -> tuple:
    """Phases 33-36 (kernel 1b's uv planes against their plain versions and
    the goldens, `earth` through `render()` on the record-walk route,
    `bench_all.py`'s earth-grad row, BASELINE config 5 with its diffuse map
    and its mesh-grad row), after phase 4 set `Ceilings`; `c5_steps` is
    phase 24's step count with the solid texture.  The maps are synthetic
    (`models.probes.synthetic_image`).  Returns the uv row of the kernels
    line and config 5's numbers with its map for the row of `rt_hit<tri>`,
    the one kernel that route launches."""
    import warnings

    import numpy as np
    import torch

    import bench_torch
    from raytracing_gpu_tpu_torch import (Camera, RenderSettings,
                                         SceneBuilder, compile_renderer,
                                         render)
    from raytracing_gpu_tpu_torch.engine import diff, film, fused_diff
    from raytracing_gpu_tpu_torch.engine import render as render_mod
    from raytracing_gpu_tpu_torch.models import probes, scenes
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    def scene_def(fn):
        scene, cam, aspect = fn(SceneBuilder, Camera)
        return scenes.SceneDef(scene, cam, aspect)

    sds = {"probe": scene_def(probes.image_probe),
           "earth": scenes.earth(probes.synthetic_image(*EARTH_MAP)),
           "spheres": scene_def(probes.image_spheres),
           "backpack": scenes.backpack_standin(
               texture=probes.synthetic_image(*BACKPACK_MAP))}
    tracers = {k: cuda_trace.Tracer(sd.scene, dev) for k, sd in sds.items()}
    for k, tr in tracers.items():
        if not tr.need_uv or tr.supports_forward:
            raise AssertionError(f"{k}: not an image scene of the record "
                                 "walk")

    # ---- 33. kernel 1b's uv planes against their plain versions ----
    with Phase("33 uv record waves"):
        ew, _, _, edepth = EARTH_RENDER
        est0 = RenderSettings(image_width=ew, aspect_ratio=sds["earth"].aspect,
                              spp_per_chunk=1, num_chunks=1, max_depth=edepth,
                              ray_batch=UV_WAVE)
        eo, ed, etm, eseed = render_mod.wave_rays(
            sds["earth"].camera.to(dev), est0, UV_WAVE, UV_WAVE,
            cuda_trace.wave_seed(base, 0, 1), dev)
        pw, pdepth = PROBE_WAVE
        sw, sdepth = SPHERES_WAVE
        cw, _, _, cdepth = CONFIG5
        # (key, label, scene, h, w, pixel base, rays, depth, ray planes)
        specs = [
            ("probe", f"image probe {pw}x{pw}, {UV_WAVE} rays, depth "
             f"{pdepth}", "probe", pw, pw, UV_WAVE, UV_WAVE, pdepth, None),
            ("earth", f"earth {ew}x{est0.image_height}, {UV_WAVE} rays, "
             f"depth {edepth}", "earth", est0.image_height, ew, UV_WAVE,
             UV_WAVE, edepth, None),
            ("earth_rays", f"earth on ray planes (kernel 1c), {UV_WAVE} "
             f"torch-drawn rays, depth {edepth}", "earth", 1, 1, 0, UV_WAVE,
             edepth, (eo, ed, etm, eseed)),
            ("spheres", f"image spheres (sphere BVH) {sw}x{sw * 9 // 16}, "
             f"{UV_WAVE} rays, depth {sdepth}", "spheres", sw * 9 // 16, sw,
             UV_WAVE, UV_WAVE, sdepth, None),
            ("backpack", f"backpack with its map (triangle BVH) {cw}x"
             f"{int(cw / CONFIG5_ASPECT)}, {REDUCED_RAYS} rays (reduced "
             f"wave), depth {cdepth}", "backpack", int(cw / CONFIG5_ASPECT),
             cw, MESH_WAVE * UV_WAVE, REDUCED_RAYS, cdepth, None)]
        waves = {}
        for key, label, name, h, w, pix, n, depth, rays in specs:
            sd, tr = sds[name], tracers[name]
            seed = cuda_trace.wave_seed(base, 0, 1)
            if rays is None:
                bound_walk = tr.bind_record(sd.camera, h, w, depth)

                def kernel(r, bound_walk=bound_walk, pix=pix, n=n,
                           seed=seed):
                    return bound_walk(pix, n, seed + r)

                def plain(r, tr=tr, sd=sd, h=h, w=w, pix=pix, n=n,
                          depth=depth, seed=seed):
                    return cuda_trace.walk_packed_pixels_reference(
                        tr.bake, sd.camera, h, w, pix, n, seed + r, depth,
                        device=dev)

                def counts(tr=tr, sd=sd, h=h, w=w, pix=pix, n=n,
                           depth=depth, seed=seed):
                    return trace_counts(tr, sd.camera, h, w, pix, n, seed,
                                        depth)
            else:
                o, d, tm, rseed = rays
                walk_rays = tr.bind_walk_packed(depth)

                def kernel(r, walk_rays=walk_rays, rseed=rseed):
                    return walk_rays(o, d, tm, rseed + r)

                def plain(r, tr=tr, depth=depth, rseed=rseed):
                    return cuda_trace.walk_packed_reference(
                        tr.bake, o, d, tm, rseed + r, depth)

                def counts(tr=tr, depth=depth, rseed=rseed):
                    return ray_counts(tr, o, d, tm, rseed, depth)
            got = kernel(0)
            cmp = record_vs_plain(got, plain(0), label)
            if len(got) != 3:
                raise AssertionError(f"{label}: {len(got)} planes, expected "
                                     "packed, u and v")
            uv_ops = sphere_uv_ops(sd.scene, got[0])
            waves[key] = time_record(
                f"megakernel_record (uv) on {label}", card, kernel, plain,
                counts,
                lambda c, tr=tr, n=n, uv_ops=uv_ops, cam=rays is None:
                record_wave_ops(tr.bake, c, n, cam) + uv_ops,
                lambda c, tr=tr, n=n, depth=depth, rp=rays is not None:
                record_wave_bytes(tr, c, n, depth, rp),
                reps=10 if name == "backpack" else 50)
            waves[key].update(max_abs_err=max(cmp["max_abs_err"],
                                              cmp["float_max_abs_err"]),
                              exact_frac=cmp["float_exact_frac"])
        # against the pinned Pallas planes (tests/test_torch_record_uv.py)
        for name, gname in (("probe", "image_probe_uv32"),
                            ("earth", "earth_fused32")):
            g = np.load(os.path.join(DATA, f"{gname}.npz"))
            gst = golden_settings(g)
            gsd = (sds["probe"] if name == "probe"
                   else scenes.earth(probes.synthetic_image(
                       *(int(x) for x in g["earth_map"]))))
            gtr = cuda_trace.Tracer(gsd.scene, dev)
            gh, gw_, gb = gst.image_height, gst.image_width, gst.ray_batch
            gwaves = [(bid * gb, gb, cuda_trace.wave_seed(int(g["base"]), s,
                                                          bid))
                      for s in range(gst.spp_per_chunk)
                      for bid in range(-(-gh * gw_ // gb))]
            planes = [gtr.walk_packed_pixels(gsd.camera, gh, gw_, *wv,
                                             gst.max_depth, gst.t_min)
                      for wv in gwaves]
            packed = torch.stack([x[0] for x in planes])
            same = None
            if "lens_cs" in g:
                same = np.stack([
                    (cuda_trace.lens_cos_sin(wseed, n, dev).cpu().numpy()
                     == g["lens_cs"][i]).all(0)
                    for i, (_, n, wseed) in enumerate(gwaves)])
            jcmp = cuda_trace.record_agreement(packed, g["planes"], same)
            ucmp = cuda_trace.uv_agreement(packed, g["planes"], torch.stack(
                [torch.stack(x[1:]) for x in planes]), g["uv"],
                cuda_trace.UV_LIMIT0[gname])
            print(f"[record-vs-jax-golden] {gname}: {jcmp}; uv {ucmp}")
            if not (jcmp["first_bounce"] and jcmp["lane_frac"] >= LANE_FLOOR
                    and ucmp["rule"]):
                raise AssertionError(f"{gname}: the uv planes disagree with "
                                     "the JAX golden")

    # ---- 34. earth through render() on the record-walk route ----
    with Phase("34 earth record-walk render"):
        esd, etr = sds["earth"], tracers["earth"]
        width, spp, chunks, depth = EARTH_RENDER
        est = RenderSettings(image_width=width, aspect_ratio=esd.aspect,
                             spp_per_chunk=spp, num_chunks=chunks,
                             max_depth=depth, ray_batch=UV_WAVE)
        engine = compile_renderer(esd.scene, esd.camera, est,
                                  dev).engine_name
        deep = render_mod.route(etr, est.with_(max_depth=50))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rr_engine = compile_renderer(
                sds["probe"].scene, sds["probe"].camera,
                est.with_(rr_start=2), dev).engine_name
        rr_warned = any("rr_start ignored" in str(x.message) for x in caught)
        print(f"[route] earth {width}x{est.image_height} {spp} spp a chunk: "
              f"depth {depth} -> {engine}, depth 50 -> {deep}; the image "
              f"probe (media) with rr_start 2 -> {rr_engine}, warned "
              f"{rr_warned}")
        if (engine != "record-walk" or deep != "regen"
                or rr_engine != "record-walk" or not rr_warned):
            raise AssertionError("image scenes take the wrong routes")
        render(esd.scene, esd.camera, est.with_(image_width=160,
                                                num_chunks=1), device=dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        eimg = render(esd.scene, esd.camera, est, device=dev)
        ewall = time.perf_counter() - t0
        ecounts = dict(launches=forward_launches(),
                       record=record_launches(),
                       ray=cuda_trace.Tracer.ray_launches,
                       hit=cuda_trace.Tracer.hit_launches)
        enb = -(-est.num_pixels // est.ray_batch)
        expected = spp * chunks * enb
        erays = est.num_pixels * est.rays_per_pixel
        emrays = erays / ewall / 1e6
        print(f"[main] render earth (engine {engine}) {width}x"
              f"{est.image_height} {est.rays_per_pixel}spp ({chunks} x "
              f"{spp}) depth {depth}: {ewall:.6f} s, {emrays:.6f} Mrays/s, "
              f"launches {ecounts} (expected {expected} ray-plane record "
              f"launches: kernel 1c with the uv planes) on {card}")
        if (ecounts["ray"] != expected or ecounts["launches"]
                or ecounts["record"] or ecounts["hit"]):
            raise AssertionError(f"earth: launches {ecounts}")
        if (eimg.shape != (est.image_height, width, 3)
                or not np.isfinite(eimg).all()
                or not 0.01 < float(eimg.mean()) < 0.999):
            raise AssertionError(f"earth: bad image {eimg.shape}, mean "
                                 f"{eimg.mean()}")
        epng = os.path.join(ROOT, "build", f"chip_smoke_earth_{width}.png")
        film.write_png(epng, eimg)
        eprof = device_busy(lambda: render(esd.scene, esd.camera, est,
                                           device=dev))
        ebusy = eprof["device_ms"] / (ewall * 1e3)
        etop = sorted(eprof["by_kernel"].items(), key=lambda kv: -kv[1][0])
        print(f"[main] earth image mean {eimg.mean():.6f} -> {epng}; device "
              f"busy share of the counted render {ebusy:.6f} "
              f"({eprof['device_ms']:.3f} ms of device time in "
              f"{ewall * 1e3:.3f} ms); top kernels (ms, count) {etop[:10]} "
              f"on {card}")

    # ---- 35. bench_all.py's earth-grad row, and the probe's two images ----
    with Phase("35 earth-grad"):
        width, spp, chunks, depth, batch = EARTH_GRAD
        gst = RenderSettings(image_width=width, aspect_ratio=1.0,
                             spp_per_chunk=spp, num_chunks=chunks,
                             max_depth=depth, ray_batch=batch)
        gchunk = render_mod.compile_param_renderer(esd.scene, esd.camera, gst,
                                                   device=dev)
        if gchunk.engine_name != "record-walk":
            raise AssertionError(f"earth-grad took {gchunk.engine_name}")
        gparams = diff.get_params(esd.scene, dev)
        gnb = -(-gst.num_pixels // batch)
        gtarget = torch.zeros((gnb * batch, 3), dtype=torch.float32,
                              device=dev)
        bench_torch.train_renders(gchunk, gparams, gtarget, [base])  # warm
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (gloss, ggrads), gcounts = counted(lambda: bench_torch.train_renders(
            gchunk, gparams, gtarget, [base]))
        gwall = time.perf_counter() - t0
        gpeak = torch.cuda.max_memory_allocated() / 2**30
        gexpected = spp * gnb * (1 if gchunk.save_planes else 2)
        grays = gst.num_pixels * gst.rays_per_pixel
        gmrays = grays / gwall / 1e6
        gnz = int((ggrads["atlas_data"] != 0).sum())
        print(f"[train] earth-grad: compile_param_renderer earth (engine "
              f"{gchunk.engine_name}) {width}x{gst.image_height} {spp}spp "
              f"depth {depth}, fwd+bwd: {gwall:.6f} s, {gmrays:.6f} "
              f"Mrays/s, launches {gcounts} (expected {gexpected} ray-plane "
              f"record launches, save_planes {gchunk.save_planes}), peak "
              f"allocated {gpeak:.3f} GiB, {gnz} nonzero atlas_data "
              f"gradients on {card}")
        gprof = device_busy(lambda: bench_torch.train_renders(
            gchunk, gparams, gtarget, [base]))
        gbusy = gprof["device_ms"] / (gwall * 1e3)
        gtop = sorted(gprof["by_kernel"].items(), key=lambda kv: -kv[1][0])
        print(f"[train] earth-grad device busy share {gbusy:.6f} "
              f"({gprof['device_ms']:.3f} ms of device time in "
              f"{gwall * 1e3:.3f} ms); top kernels (ms, count) {gtop[:8]}")
        if (gcounts["ray"] != gexpected or gcounts["launches"]
                or gcounts["record"] or gcounts["hit"] or gnz == 0
                or not bool(torch.isfinite(gloss))
                or not all(bool(torch.isfinite(v).all())
                           for v in ggrads.values())):
            raise AssertionError("the earth-grad row is off")
        # the same chunk over the plain record walk on the card
        cam = esd.camera.to(dev)

        def plain_walk(pb, n, seed):
            o, d, tm, kseed = render_mod.wave_rays(cam, gst, pb, n, seed,
                                                   dev)
            return cuda_trace.walk_packed_reference(etr.bake, o, d, tm,
                                                    kseed, depth, gst.t_min)

        pchunk = fused_diff.fused_chunk_from_walk(esd.scene, plain_walk, gst,
                                                  device=dev)
        ploss, pgrads = bench_torch.train_renders(pchunk, gparams, gtarget,
                                                  [base])
        gcmp = grad_cmp(ggrads, pgrads)
        gcmp["loss_equal"] = bool(torch.equal(gloss, ploss))
        print(f"[fused-vs-plain] earth-grad chunk over the kernel's walk "
              f"against the plain walk on the card: gradients {gcmp}")
        if not gcmp["ok"]:
            raise AssertionError("earth-grad: kernel and plain walks give "
                                 "other gradients")
        # the probe's two images each get atlas gradients
        psd = sds["probe"]
        width, spp, chunks, depth, batch = PROBE_GRAD
        pst = RenderSettings(image_width=width, aspect_ratio=1.0,
                             spp_per_chunk=spp, num_chunks=chunks,
                             max_depth=depth, ray_batch=batch)
        prchunk = render_mod.compile_param_renderer(psd.scene, psd.camera,
                                                    pst, device=dev)
        pparams = diff.get_params(psd.scene, dev)
        (_, prgrads), prcounts = counted(lambda: bench_torch.train_renders(
            prchunk, pparams, torch.zeros((pst.num_pixels, 3), device=dev),
            [base]))
        split = int(psd.scene.atlas.offset[1]) * 3
        ga = prgrads["atlas_data"]
        spans = (int((ga[:split] != 0).sum()), int((ga[split:] != 0).sum()))
        print(f"[train] image probe {width}x{width} {spp}spp depth {depth} "
              f"(engine {prchunk.engine_name}): nonzero atlas_data "
              f"gradients in its two images {spans}, launches {prcounts}")
        if min(spans) == 0 or prcounts["ray"] == 0:
            raise AssertionError("the probe's images do not both get "
                                 "gradients")

    # ---- 36. BASELINE config 5 with its map, and its mesh-grad row ----
    with Phase("36 config 5 with its map"):
        bsd = sds["backpack"]
        width, spp, chunks, depth = CONFIG5
        c5 = RenderSettings(image_width=width, aspect_ratio=CONFIG5_ASPECT,
                            spp_per_chunk=spp, num_chunks=chunks,
                            max_depth=depth, ray_batch=CONFIG5_RAY_BATCH)
        engine = compile_renderer(bsd.scene, bsd.camera, c5, dev).engine_name
        if engine != "regen":
            raise AssertionError(f"config 5 with its map took {engine}")
        render(bsd.scene, bsd.camera, c5.with_(image_width=160, num_chunks=1,
                                               spp_per_chunk=16), device=dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        img = render(bsd.scene, bsd.camera, c5, device=dev)
        wall = time.perf_counter() - t0
        steps = cuda_trace.Tracer.hit_launches
        stray = (forward_launches() + record_launches()
                 + cuda_trace.Tracer.ray_launches)
        rays5 = c5.num_pixels * c5.rays_per_pixel
        mrays5 = rays5 / wall / 1e6
        print(f"[main] render backpack with its map (config 5, engine "
              f"{engine}) {width}x{c5.image_height} {c5.rays_per_pixel}spp "
              f"depth {depth}: {wall:.6f} s, {mrays5:.6f} Mrays/s, hit "
              f"launches {steps} ({c5_steps} with the solid texture, phase "
              f"24), host time per step {wall * 1e3 / max(steps, 1):.6f} ms, "
              f"other launches {stray} on {card}")
        if (steps == 0 or stray != 0 or not np.isfinite(img).all()
                or not 0.05 < float(img.mean()) < 0.999):
            raise AssertionError(f"config 5 with its map: {steps} steps, "
                                 f"{stray} other launches, mean {img.mean()}")
        film.write_png(os.path.join(ROOT, "build",
                                    f"chip_smoke_backpack_map_{width}.png"),
                       img)
        sub = c5.with_(spp_per_chunk=CONFIG5_PROFILED_SPP, num_chunks=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(bsd.scene, bsd.camera, sub, device=dev)
        sub_wall = time.perf_counter() - t0
        prof = device_busy(lambda: render(bsd.scene, bsd.camera, sub,
                                          device=dev))
        busy5 = prof["device_ms"] / (sub_wall * 1e3)
        top = sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1][0])
        print(f"[main] config 5 with its map, bounded sub-run (one "
              f"{CONFIG5_PROFILED_SPP}-spp chunk): device "
              f"{prof['device_ms']:.3f} ms in {sub_wall * 1e3:.3f} ms "
              f"unprofiled, busy share {busy5:.6f}; top kernels (ms, count) "
              f"{top[:12]} on {card}")
        # bench_all.py's mesh-grad row with the map
        width, spp, chunks, depth, batch = MESH_GRAD
        mst = RenderSettings(image_width=width, aspect_ratio=CONFIG5_ASPECT,
                             spp_per_chunk=spp, num_chunks=chunks,
                             max_depth=depth, ray_batch=batch)
        mchunk = render_mod.compile_param_renderer(bsd.scene, bsd.camera, mst,
                                                   device=dev,
                                                   debug_stats=True)
        if mchunk.engine_name != "wavefront-record":
            raise AssertionError(f"mesh-grad took {mchunk.engine_name}")
        mparams = diff.get_params(bsd.scene, dev)
        stats = {}

        def mesh_grad():
            def chunk(p):
                sums, st_ = mchunk(p, base)
                stats.update(st_)
                return sums
            return diff.value_and_grad(mparams, chunk, 0.0)

        mesh_grad()  # warm-up
        t0 = time.perf_counter()
        (mloss, mgrads), mcounts = counted(mesh_grad)
        mwall = time.perf_counter() - t0
        mrays = mst.num_pixels * mst.rays_per_pixel
        mnz = int((mgrads["atlas_data"] != 0).sum())
        print(f"[main] mesh-grad with the map: compile_param_renderer "
              f"backpack (engine {mchunk.engine_name}) {width}x"
              f"{mst.image_height} {spp}spp depth {depth}, fwd+bwd: "
              f"{mwall:.6f} s, {mrays / mwall / 1e6:.6f} Mrays/s, launches "
              f"{mcounts} for {stats['iterations']} bounces, {mnz} nonzero "
              f"atlas_data gradients on {card}")
        if (mcounts["hit"] != stats["iterations"] or mcounts["hit"] == 0
                or mcounts["launches"] or mcounts["record"] or mcounts["ray"]
                or mnz == 0 or not bool(torch.isfinite(mloss))):
            raise AssertionError("the mesh-grad row with the map is off")
        mprof = device_busy(mesh_grad)
        mbusy = mprof["device_ms"] / (mwall * 1e3)
        mtop = sorted(mprof["by_kernel"].items(), key=lambda kv: -kv[1][0])
        print(f"[main] mesh-grad with the map device busy share "
              f"{mbusy:.6f} ({mprof['device_ms']:.3f} ms of device time in "
              f"{mwall * 1e3:.3f} ms); top kernels (ms, count) {mtop[:8]}")

    main_wave = waves["earth_rays"]
    return {
        "name": "megakernel_record<uv,rays>", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": ecounts["ray"],
        **{k: main_wave[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "max_abs_err",
                                     "exact_frac", "loop_ms")},
        "library_ms": None,
        "waves": waves,
        "earth_render_mrays_per_s": emrays,
        "earth_render_device_busy_share": ebusy,
        "earth_grad_mrays_per_s": gmrays,
        "earth_grad_peak_allocated_gib": gpeak,
        "earth_grad_device_busy_share": gbusy,
        "earth_grad_launches": gcounts["ray"]}, {
        "config5_map_mrays_per_s": mrays5, "config5_map_steps": steps,
        "config5_map_host_ms_per_step": wall * 1e3 / steps,
        "config5_map_subrun_device_busy_share": busy5,
        "mesh_grad_map_mrays_per_s": mrays / mwall / 1e6,
        "mesh_grad_map_device_busy_share": mbusy}


def trace_counts(tracer, camera, h: int, w: int, pix: int, n: int,
                 seed: int, depth: int) -> dict:
    """The work counts of a camera-ray wave (the forward plain version's on
    the same seed: the record walk follows the same paths)."""
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    counts = {}
    cuda_trace.trace_pixels_reference(tracer.bake, camera, h, w, pix, n, seed,
                                      depth, device=tracer.device,
                                      counts=counts)
    return counts


def ray_counts(tracer, o, d, tm, seed: int, depth: int) -> dict:
    """`trace_counts` for a wave of given rays."""
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    counts = {}
    cuda_trace.trace_rays_reference(tracer.bake, o, d, tm, seed, depth,
                                    counts=counts)
    return counts


def oracle_cmp(xla, res, d, alive, mat_floor: float) -> dict:
    """The xla engine's hit records against `rt_hit`'s resolved ones on the
    live lanes: hit equal on every lane, the material on >= `mat_floor` of
    the hits, and over the lanes that agree p over |d| (p = o + t d: t's
    error), the normal and u, v (u modulo 1) within `hit_agreement`'s
    limits, >= 99% of them within HIT_CLOSE."""
    import torch

    from raytracing_gpu_tpu_torch.ops import cuda_trace

    hit_equal = bool(torch.equal(xla.hit & alive, res.hit & alive))
    hit = res.hit & alive
    same = hit & (xla.mat_id.long() == res.mat_id.long())
    scale = torch.linalg.vector_norm(d.double(), dim=1).clamp(min=1.0)
    errs, close = {}, torch.ones_like(same)
    for name, limit in cuda_trace.HIT_LIMITS.items():
        got, want = getattr(xla, name), getattr(res, name)
        err = (got.double() - want.double()).abs()
        if name == "u":
            err = torch.minimum(err, 1.0 - err)
        if err.dim() == 2:
            err = err.amax(-1)
        if name == "p":
            err = err / scale
        errs[name] = float(err[same].max()) if bool(same.any()) else 0.0
        close &= err <= cuda_trace.HIT_CLOSE
        errs[name + "_ok"] = errs[name] <= limit
    mat_frac = float(same.sum()) / max(int(hit.sum()), 1)
    close_frac = float((close & same).sum()) / max(int(same.sum()), 1)
    ok = (hit_equal and mat_frac >= mat_floor and close_frac >= 0.99
          and all(v for k, v in errs.items() if k.endswith("_ok")))
    return dict(ok=ok, hits=int(hit.sum()), hit_equal=hit_equal,
                mat_frac=mat_frac, close_frac=close_frac,
                max_err={k: v for k, v in errs.items()
                         if not k.endswith("_ok")})


def oracle_rays(label: str, sd, tracer, geom, rays, bounce: bool) -> tuple:
    """Phase 39 on one set of rays: `closest_hit` (media-free: no draws)
    against `rt_hit` and its resolve, with triangle winners by id.
    Returns the comparison and `rt_hit`'s resolved records."""
    import torch

    from raytracing_gpu_tpu_torch.accel import traverse
    from raytracing_gpu_tpu_torch.engine import intersect, wavefront

    o, d, tm, alive = rays
    t0 = time.perf_counter()
    xla = intersect.closest_hit(sd.scene, o, d, tm, geom=geom)
    torch.cuda.synchronize()
    xla_s = time.perf_counter() - t0
    hr = tracer.hit(o, d, tm, alive)
    table = wavefront.pack_attr_table(sd.scene, tracer.bake.tri_perm,
                                      o.device)
    res = wavefront.resolve_hit_packed(table, *hr, d)
    cmp = oracle_cmp(xla, res, d, alive, ORACLE_MAT_FLOOR[int(bounce)])
    if geom.tri_bvh is not None:
        t_t, i_t = traverse.traverse_triangles(geom.triangles, geom.tri_bvh,
                                               o, d, 0.001)
        perm = torch.as_tensor(tracer.bake.tri_perm, device=o.device).long()
        k_tri = alive & (((hr.packed >> 20) & 1) == 1)
        x_tri = alive & xla.hit & (t_t == xla.t)
        both = k_tri & x_tri
        ids_equal = both & (perm[hr.slot.long()] == i_t)
        # two triangles at one distance: across an edge they share
        gap = (torch.linalg.vector_norm(xla.p - res.p, dim=1)
               / torch.linalg.vector_norm(d, dim=1).clamp(min=1.0))
        tie = both & ~ids_equal & (gap <= HIT_TIE_LIMIT)
        cmp["triangle_winners"] = int(k_tri.sum())
        cmp["triangle_id_frac"] = (float(ids_equal.sum()) / int(both.sum())
                                   if bool(both.any()) else 1.0)
        cmp["triangle_ties"] = int(tie.sum())
        cmp["ok"] = (cmp["ok"] and bool(torch.equal(k_tri, x_tri))
                     and cmp["triangle_id_frac"] >= ORACLE_TRI_ID_FLOOR
                     and int((both & ~ids_equal & ~tie).sum()) == 0)
    cmp["xla_s"] = xla_s
    print(f"[oracle] {label}: {int(alive.sum())} live rays: {cmp}")
    if not cmp["ok"]:
        raise AssertionError(f"{label}: the xla engine and rt_hit disagree")
    return cmp, res


def bounce_rays(sd, res, rays, seed: int):
    """The rays that go on from `rt_hit`'s resolved hits of `rays`, along
    directions scattered in torch."""
    import torch

    from raytracing_gpu_tpu_torch.engine import diff
    from raytracing_gpu_tpu_torch.scene import materials

    o, d, tm, alive = rays
    gen = torch.Generator(device=o.device).manual_seed(seed)
    sc = materials.scatter(sd.scene, diff.get_params(sd.scene, o.device), gen,
                           d, res.p, res.normal, res.front_face, res.u, res.v,
                           res.mat_id)
    alive = alive & res.hit & sc.ok
    return (torch.where(alive[:, None], res.p, o).contiguous(),
            torch.where(alive[:, None], sc.direction, d).contiguous(), tm,
            alive)


def xla_phases(dev, card: str, base: int) -> None:
    """Phases 39-41: the xla engine as `rt_hit`'s oracle, its renders and
    the checkpoint's resume, and `bench_all_torch.py`'s rows."""
    import tempfile

    import numpy as np
    import torch

    import bench_all_torch
    import bench_torch
    from raytracing_gpu_tpu_torch import RenderSettings, compile_renderer
    from raytracing_gpu_tpu_torch.core.camera import Camera
    from raytracing_gpu_tpu_torch.engine import diff, intersect
    from raytracing_gpu_tpu_torch.engine import render as render_mod
    from raytracing_gpu_tpu_torch.models import probes, scenes
    from raytracing_gpu_tpu_torch.ops import cuda_trace
    from raytracing_gpu_tpu_torch.scene.builder import SceneBuilder

    with Phase("39 the xla engine against rt_hit"):
        for name, n in ORACLE_RAYS.items():
            sd = scenes.get(name)
            tracer = cuda_trace.Tracer(sd.scene, dev)
            geom = intersect.geometry(sd.scene, dev)
            rays = camera_rays(sd, n, 39, dev)
            _, res = oracle_rays(f"{name} camera", sd, tracer, geom, rays,
                                 False)
            oracle_rays(f"{name} bounce", sd, tracer, geom,
                        bounce_rays(sd, res, rays, 40), True)

    def rate(label, st, run, sub):
        """Mrays/s of `run()` on the host clock, with every launch count
        read (the xla route launches no hand kernel); its busy share is a
        sub-run's (`sub`, the same route and waves at XLA_SUB_SPP spp): the
        device time of a profiled repeat over the sub-run's own wall.  The
        sub-run first warms the route up."""
        sub()
        t0 = time.perf_counter()
        out, counts = counted(run)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sub()
        torch.cuda.synchronize()
        sub_wall = time.perf_counter() - t0
        prof = device_busy(sub)
        mrays = st.num_pixels * st.rays_per_pixel / wall / 1e6
        busy = prof["device_ms"] / (sub_wall * 1e3)
        top = sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1][0])
        print(f"[xla] {label}: {wall:.6f} s, {mrays:.6f} Mrays/s, launches "
              f"{counts}; a {XLA_SUB_SPP}-spp sub-run {sub_wall:.6f} s, "
              f"device busy share {busy:.6f} ({prof['device_ms']:.3f} ms of "
              f"device time), top kernels (ms, count) {top[:4]}; on {card}")
        if any(counts.values()):
            raise AssertionError(f"{label}: the xla route launched a kernel")
        return out

    with Phase("40 xla renders, checkpoint and resume"):
        sd = scenes.get("cornell_box")
        width, spp, chunks, depth = XLA_CORNELL
        st = RenderSettings(image_width=width, aspect_ratio=1.0,
                            spp_per_chunk=spp, num_chunks=chunks,
                            max_depth=depth, ray_batch=65536)
        xchunk = compile_renderer(sd.scene, sd.camera, st, dev, engine="xla")
        if xchunk.engine_name != "xla":
            raise AssertionError("engine='xla' took " + xchunk.engine_name)
        xsub = compile_renderer(sd.scene, sd.camera,
                                st.with_(spp_per_chunk=XLA_SUB_SPP), dev,
                                engine="xla")
        xsums = rate(f"cornell_box {width}x{width} {spp}spp depth {depth} "
                     "(engine xla)", st, lambda: xchunk(base).cpu(),
                     lambda: xsub(base).cpu())
        msums = compile_renderer(sd.scene, sd.camera, st, dev)(base).cpu()
        n = st.num_pixels
        z = z_scores(xsums[:n].numpy(), msums[:n].numpy())
        print(f"[xla] cornell_box xla against the megakernel route, one "
              f"{spp}-spp chunk: per-channel z {z.tolist()}, means "
              f"{xsums[:n].mean(0).tolist()} and {msums[:n].mean(0).tolist()}")
        if not (np.isfinite(xsums.numpy()).all()
                and (np.abs(z) < Z_LIMIT).all()):
            raise AssertionError("the xla route's Cornell image is off")

        mscene, mcam, _ = probes.many_media(SceneBuilder, Camera)
        width, spp, chunks, depth = XLA_MEDIA
        mst = RenderSettings(image_width=width, aspect_ratio=1.0,
                             spp_per_chunk=spp, num_chunks=chunks,
                             max_depth=depth, ray_batch=65536)
        mchunk = compile_renderer(mscene, mcam, mst, dev)
        if mchunk.engine_name != "xla":
            raise AssertionError("many_media took " + mchunk.engine_name)
        msub = compile_renderer(mscene, mcam,
                                mst.with_(spp_per_chunk=XLA_SUB_SPP), dev)
        msums = rate(f"many_media ({cuda_trace.unported_feature(mscene)}) "
                     f"{width}x{width} {spp}spp depth {depth} (auto -> xla)",
                     mst, lambda: mchunk(base).cpu(),
                     lambda: msub(base).cpu())
        if not (np.isfinite(msums.numpy()).all() and msums.mean() > 0):
            raise AssertionError("the many_media image is off")

        width, spp, chunks, depth, batch = XLA_TRAIN
        tst = RenderSettings(image_width=width, aspect_ratio=1.0,
                             spp_per_chunk=spp, num_chunks=chunks,
                             max_depth=depth, ray_batch=batch)
        pchunk = render_mod.compile_param_renderer(sd.scene, sd.camera, tst,
                                                   engine="xla", device=dev)
        params = diff.get_params(sd.scene, dev)
        target = torch.zeros((render_mod._grid_geometry(tst)[3], 3),
                             device=dev)
        tsub_st = tst.with_(spp_per_chunk=XLA_SUB_SPP)
        tsub = render_mod.compile_param_renderer(sd.scene, sd.camera, tsub_st,
                                                 engine="xla", device=dev)
        tsub_target = torch.zeros((render_mod._grid_geometry(tsub_st)[3], 3),
                                  device=dev)
        loss, grads = rate(
            f"cornell_box training chunk {width}x{width} {spp}spp depth "
            f"{depth} fwd+bwd (engine {pchunk.engine_name})", tst,
            lambda: bench_torch.train_renders(pchunk, params, target,
                                              [base]),
            lambda: bench_torch.train_renders(tsub, params, tsub_target,
                                              [base]))
        nz = int((grads["tex_c1"] != 0).sum())
        if not (pchunk.engine_name == "xla" and bool(torch.isfinite(loss))
                and nz > 0 and all(bool(torch.isfinite(g).all())
                                   for g in grads.values())):
            raise AssertionError("the xla training chunk is off")

        width, spp, chunks, depth, stop = RESUME
        rst = RenderSettings(image_width=width, aspect_ratio=1.0,
                             spp_per_chunk=spp, num_chunks=chunks,
                             max_depth=depth, ray_batch=65536, seed=base)
        full = render_mod.render_linear(sd.scene, sd.camera, rst, device=dev)

        class Stop(Exception):
            pass

        def stop_at(c, _n, _dt):
            if c == stop:
                raise Stop

        with tempfile.TemporaryDirectory() as ckdir:
            try:
                render_mod.render_linear(sd.scene, sd.camera, rst,
                                         device=dev, checkpoint_dir=ckdir,
                                         progress=stop_at)
            except Stop:
                pass
            ran = []
            resumed = render_mod.render_linear(
                sd.scene, sd.camera, rst, device=dev, checkpoint_dir=ckdir,
                progress=lambda c, _n, _dt: ran.append(c))
        equal = bool(np.array_equal(resumed, full))
        print(f"[resume] cornell_box {width}x{width} {chunks} x {spp}spp "
              f"stopped after chunk {stop}, resumed by a fresh renderer "
              f"(chunks run {ran}): equal to the uninterrupted render bit "
              f"for bit {equal}")
        if not equal or ran != list(range(stop + 1, chunks + 1)):
            raise AssertionError("the resumed render differs")

    with Phase("41 bench_all_torch.py rows"):
        rows = [bench_all_torch.bench_forward(k, BENCH_SPP_SCALE, dev)
                for k in BENCH_CONFIGS]
        rows += [bench_all_torch.bench_grad(w, dev)
                 for w in ("earth", "mesh")]
        for row in rows:
            print(f"[bench_all_torch] --spp-scale {BENCH_SPP_SCALE}: "
                  f"{json.dumps(row)}")
            if not np.isfinite(row["mrays_per_s"]):
                raise AssertionError(f"bench row {row['scene']} is off")


def par_settings(kind: str):
    """Phase 42's Cornell training chunk or big_scene1 render settings."""
    from raytracing_gpu_tpu_torch import RenderSettings
    from raytracing_gpu_tpu_torch.models import scenes

    if kind == "train":
        width, spp, depth, batch = PAR_TRAIN
        return RenderSettings(image_width=width, aspect_ratio=1.0,
                              spp_per_chunk=spp, num_chunks=1,
                              max_depth=depth, ray_batch=batch)
    width, spp, chunks, depth, batch = PAR_SERVE
    return RenderSettings(image_width=width,
                          aspect_ratio=scenes.get(BIG).aspect,
                          spp_per_chunk=spp, num_chunks=chunks,
                          max_depth=depth, ray_batch=batch)


def par_barrier(dev) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.synchronize(dev)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def par_timed(dev, fn) -> tuple:
    """(fn's result, launch counts, seconds) between barriers of the
    world, the counts set to 0 just before."""
    par_barrier(dev)
    t0 = time.perf_counter()
    out, counts = counted(fn)
    par_barrier(dev)
    return out, counts, time.perf_counter() - t0


def par_train(dev, mesh, base: int) -> dict:
    """Config 3's training chunk (`compile_fused_param_renderer`, gen_rays)
    on `mesh`, or unsharded for None: the primal on the image, the L2 loss
    against a zero target and its gradients, counted and timed."""
    import torch

    from raytracing_gpu_tpu_torch.engine import diff, fused_diff
    from raytracing_gpu_tpu_torch.models import scenes

    st = par_settings("train")
    sd = scenes.get("cornell_box")
    chunk = fused_diff.compile_fused_param_renderer(sd.scene, sd.camera, st,
                                                    device=dev, mesh=mesh)
    params = diff.get_params(sd.scene, dev)
    npix = st.num_pixels
    seen = {}

    def render_fn(p):
        seen["primal"] = chunk(p, base)[:npix]
        return seen["primal"]

    target = torch.zeros(npix, 3, device=dev)
    diff.value_and_grad(params, render_fn, target)   # warm-up
    (loss, grads), counts, sec = par_timed(dev, lambda: diff.value_and_grad(
        params, render_fn, target))
    return dict(primal=seen["primal"].detach().cpu(), loss=loss.cpu(),
                grads={k: v.cpu() for k, v in grads.items()}, counts=counts,
                seconds=sec, mrays_per_s=npix * st.spp_per_chunk / sec / 1e6)


def par_serve(dev, mesh) -> dict:
    """Config 2's render through `make_sharded_chunk_fn` and
    `render_linear` on `mesh`, counted and timed."""
    import torch

    from raytracing_gpu_tpu_torch.engine.render import render_linear
    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.parallel.render import make_sharded_chunk_fn

    st = par_settings("serve")
    sd = scenes.get(BIG)
    chunk_fn = make_sharded_chunk_fn(mesh, sd.scene, sd.camera, st,
                                     device=dev)
    linear, counts, sec = par_timed(dev, lambda: render_linear(
        sd.scene, sd.camera, st, device=dev, chunk_fn=chunk_fn))
    return dict(engine=chunk_fn.engine_name, linear=torch.from_numpy(linear),
                counts=counts, seconds=sec,
                mrays_per_s=st.num_pixels * st.rays_per_pixel / sec / 1e6)


def par_megakernel(dev, mesh, base: int) -> dict:
    """One 16-spp chunk of config 2 through `compile_sharded_renderer` on
    `mesh` (2, 1): 8 spp a rank, so the megakernel route, kernel 1c on
    torch-drawn rays.  The whole frame, counted and timed."""
    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.parallel.render import (
        compile_sharded_renderer)

    st = par_settings("serve")
    sd = scenes.get(BIG)
    chunk = compile_sharded_renderer(sd.scene, sd.camera, st, mesh,
                                     device=dev)
    frame, counts, sec = par_timed(dev, lambda: mesh.gather_dp(chunk(base)))
    return dict(engine=chunk.engine_name,
                frame=frame[:st.num_pixels].cpu(), counts=counts,
                seconds=sec,
                mrays_per_s=st.num_pixels * st.spp_per_chunk / sec / 1e6)


def par_all_reduce_ms(dev, mesh) -> float:
    """ms of one `all_reduce` of a (512 * 512 / 2, 3) float32 array over
    the sp group of `mesh`, by the difference of two runs of repeated
    reduces (bench_all.py:341-355)."""
    import torch

    rows, (lo, hi) = PAR_ALL_REDUCE
    x = torch.ones((rows, 3), dtype=torch.float32, device=dev)

    def run(reps: int) -> float:
        par_barrier(dev)
        t0 = time.perf_counter()
        y = x
        for i in range(reps):
            y = mesh.sum_sp(y * (1.0 + 1e-9 * i))
        par_barrier(dev)
        return time.perf_counter() - t0

    run(lo)   # warm-up
    return (run(hi) - run(lo)) / (hi - lo) * 1e3


def parallel_rank(dev, base: int) -> dict:
    """One rank of phase 42's two-rank world: config 3's training chunk at
    (sp, dp) = (2, 1) and (1, 2), config 2's render at (1, 2) (regen) and
    one of its chunks at (2, 1) (megakernel), and the sp all_reduce."""
    import torch.distributed as dist

    from raytracing_gpu_tpu_torch.parallel.mesh import make_mesh

    meshes = {f"{s}x{d}": make_mesh(s, d) for s, d in PAR_MESHES}
    out = dict(rank=dist.get_rank(), backend=dist.get_backend())
    for name, mesh in meshes.items():
        out[f"train_{name}"] = par_train(dev, mesh, base)
    out["regen_1x2"] = par_serve(dev, meshes["1x2"])
    out["megakernel_2x1"] = par_megakernel(dev, meshes["2x1"], base)
    out["all_reduce_ms"] = par_all_reduce_ms(dev, meshes["2x1"])
    return out


def nccl_rank(dev) -> dict:
    """One NCCL all_reduce, on ranks that may share a card."""
    import torch
    import torch.distributed as dist

    x = torch.ones(4, device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize(dev)
    return dict(sum=x.cpu())


def stat_cmp(got, want) -> dict:
    """tests/test_parallel.py's rule for two regen estimates (mean within
    3% + 5e-3, correlation > 0.9), with the per-channel z-scores."""
    import numpy as np

    a = np.asarray(got, np.float64).reshape(-1, 3)
    b = np.asarray(want, np.float64).reshape(-1, 3)
    rel, floor, corr_min = PAR_STAT
    corr = float(np.corrcoef(a.reshape(-1), b.reshape(-1))[0, 1])
    mean_err = abs(float(a.mean()) - float(b.mean()))
    return dict(ok=mean_err < rel * float(b.mean()) + floor
                and corr > corr_min, mean=float(a.mean()),
                want_mean=float(b.mean()), corr=corr,
                z=[float(z) for z in z_scores(a, b)])


def train_cmp(got: dict, want: dict) -> dict:
    """A sharded training chunk against the unsharded one: the primal
    within rtol 1e-6 / atol 1e-7 and the gradients within 2e-5 of their
    scale (tests/test_parallel.py), with the bit-exact shares."""
    import torch

    res = dict(ok=bool(torch.allclose(got["primal"], want["primal"],
                                      rtol=1e-6, atol=1e-7)),
               primal_exact=float((got["primal"] == want["primal"])
                                  .double().mean()),
               primal_max_abs_err=float((got["primal"] - want["primal"])
                                        .abs().max()))
    for k, w in want["grads"].items():
        err = float((got["grads"][k] - w).abs().max())
        scale = float(w.abs().max()) + 1e-12
        res[f"{k}_rel_err"] = err / scale
        res["ok"] = res["ok"] and err <= 2e-5 * scale
    return res


def parallel_phases(dev, card: str, base: int) -> dict:
    """Phase 42: `parallel/` on a world of one rank (NCCL) at full width,
    then on two spawned ranks that share the card; returns each kernel's
    launches on those paths, for the kernels line."""
    import datetime

    import torch
    import torch.distributed as dist

    from raytracing_gpu_tpu_torch.engine import render as render_mod
    from raytracing_gpu_tpu_torch.engine.wavefront import (
        compile_regen_renderer)
    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.ops import cuda_trace
    from raytracing_gpu_tpu_torch.parallel import distributed, dryrun
    from raytracing_gpu_tpu_torch.parallel.mesh import make_mesh
    from raytracing_gpu_tpu_torch.parallel.render import REGEN_SALT

    st = par_settings("serve")
    sd = scenes.get(BIG)
    npix = st.num_pixels
    with Phase("42 parallel: a world of one rank"):
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{dryrun.free_port()}",
            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
        try:
            x = torch.ones(4, device=dev)
            dist.all_reduce(x)
            mesh = make_mesh()
            one = par_train(dev, mesh, base)
            single = par_train(dev, None, base)
            exact = (torch.equal(one["primal"], single["primal"])
                     and all(torch.equal(one["grads"][k], single["grads"][k])
                             for k in single["grads"]))
            print(f"[parallel] world of one ({dist.get_backend()}), config 3"
                  f" training chunk {PAR_TRAIN}: sharded on {mesh} equals "
                  f"the unsharded chunk bit for bit {exact} (primal and "
                  f"gradients); launches {one['counts']} against "
                  f"{single['counts']}; {one['mrays_per_s']:.6f} against "
                  f"{single['mrays_per_s']:.6f} Mrays/s on {card}")
            if not exact or one["counts"]["record_chunk"] == 0:
                raise AssertionError("the 1x1 training chunk differs from "
                                     "the unsharded one")
            # index_add_ sums in a fixed order only in deterministic mode
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                served = par_serve(dev, mesh)
                body = compile_regen_renderer(
                    sd.scene, sd.camera, st, device=dev,
                    _local=(npix, st.spp_per_chunk))
                sums = torch.zeros((npix, 3), dtype=torch.float32,
                                   device=dev)
                for b in render_bases(st):
                    sums += body(cuda_trace.wave_seed(b, REGEN_SALT, 0),
                                 0)[:npix]
                local = (sums / float(st.rays_per_pixel)).cpu().reshape(
                    st.image_height, st.image_width, 3)
            finally:
                torch.use_deterministic_algorithms(False)
            plain = torch.from_numpy(render_mod.render_linear(
                sd.scene, sd.camera, st, device=dev))
            body_exact = torch.equal(served["linear"], local)
            scmp = stat_cmp(served["linear"], plain)
            print(f"[parallel] world of one, config 2 {PAR_SERVE}: engine "
                  f"{served['engine']}, equals the regen body without a "
                  f"process group bit for bit {body_exact}; against the "
                  f"unsharded regen render {scmp}; launches "
                  f"{served['counts']}, {served['mrays_per_s']:.6f} Mrays/s "
                  f"on {card}")
            if not (served["engine"] == "regen" and body_exact and scmp["ok"]
                    and served["counts"]["hit"] > 0):
                raise AssertionError("the 1x1 regen render is off")
        finally:
            dist.destroy_process_group()

    with Phase("42 parallel: two ranks on one card"):
        backend = distributed.choose_backend("cuda", 2)
        t0 = time.perf_counter()
        ranks = dryrun.spawn(2, "chip_smoke:parallel_rank", {"base": base},
                             device="cuda", deadline=PAR_DEADLINE)
        world_s = time.perf_counter() - t0
        tracer = cuda_trace.Tracer(sd.scene, dev)
        want_mega = render_mod.chunk_sums(
            sd.scene, sd.camera, st, base,
            lambda _sc, o, d, tm, seed: tracer(o, d, tm, seed, st.max_depth,
                                               st.t_min), dev)[:npix].cpu()
        launches = dict(train={}, regen={}, megakernel={})
        for r, out in enumerate(ranks):
            res = dict(backend=out["backend"])
            for name in ("2x1", "1x2"):
                t = out[f"train_{name}"]
                res[f"train_{name}"] = dict(train_cmp(t, single),
                                            counts=t["counts"],
                                            mrays_per_s=t["mrays_per_s"])
            rg = out["regen_1x2"]
            res["regen_1x2"] = dict(stat_cmp(rg["linear"], plain),
                                    engine=rg["engine"], counts=rg["counts"],
                                    mrays_per_s=rg["mrays_per_s"])
            mk = out["megakernel_2x1"]
            res["megakernel_2x1"] = dict(
                ok=bool(torch.allclose(mk["frame"], want_mega, rtol=2e-5,
                                       atol=1e-5)),
                max_abs_err=float((mk["frame"] - want_mega).abs().max()),
                engine=mk["engine"], counts=mk["counts"],
                mrays_per_s=mk["mrays_per_s"])
            res["all_reduce_ms"] = out["all_reduce_ms"]
            print(f"[parallel] rank {r} of 2 on one card ({out['backend']}):"
                  f" {json.dumps(res)} on {card}")
            launches["train"][f"rank{r}"] = sum(
                res[f"train_{m}"]["counts"]["record_chunk"]
                for m in ("2x1", "1x2"))
            launches["regen"][f"rank{r}"] = rg["counts"]["hit"]
            launches["megakernel"][f"rank{r}"] = mk["counts"]["ray"]
            if not (out["backend"] == backend
                    and all(res[f"train_{m}"]["ok"] for m in ("2x1", "1x2"))
                    and res["regen_1x2"]["ok"] and rg["engine"] == "regen"
                    and res["megakernel_2x1"]["ok"]
                    and mk["engine"] == "megakernel"
                    and all(res[f"train_{m}"]["counts"]["record_chunk"] > 0
                            for m in ("2x1", "1x2"))
                    and rg["counts"]["hit"] > 0 and mk["counts"]["ray"] > 0):
                raise AssertionError(f"rank {r}: a sharded route is off or "
                                     "launched no kernel")
        print(f"[parallel] the two-rank world took {world_s:.6f} s (spawn "
              f"included); ranks share one card, so its rates are not "
              f"scaling across cards; on {card}")
        try:
            dryrun.spawn(2, "chip_smoke:nccl_rank", device="cuda",
                         backend="nccl", deadline=NCCL_DEADLINE)
            nccl = "accepted"
        except (RuntimeError, TimeoutError) as e:
            lines = [ln for ln in str(e).splitlines()
                     if "Duplicate GPU" in ln or "ncclInvalidUsage" in ln
                     or "Error" in ln]
            lines.sort(key=lambda ln: "Duplicate GPU" not in ln)
            nccl = "refused: " + (lines[0][:300] if lines else
                                  type(e).__name__)
        print(f"[parallel] NCCL with two ranks on one card: {nccl}; the "
              f"backend chosen for ranks that share a card: {backend}")
    launches["world1"] = dict(train=one["counts"]["record_chunk"],
                              regen=served["counts"]["hit"])
    return launches



def tool(name: str):
    """The module `tools/<name>.py`."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def deep_phases(dev, card: str, base: int) -> dict:
    """Phase 43: the reference depth 50 with russian roulette from bounce
    DEEP_RR_START, after phase 4 set `Ceilings`.  Returns the launches of
    its renders by path."""
    import numpy as np
    import torch

    from raytracing_gpu_tpu_torch import (Camera, RenderSettings,
                                         SceneBuilder, cli, compile_renderer)
    from raytracing_gpu_tpu_torch.engine import film
    from raytracing_gpu_tpu_torch.engine.render import _grid_geometry
    from raytracing_gpu_tpu_torch.engine.wavefront import (
        compile_regen_renderer)
    from raytracing_gpu_tpu_torch.models import probes, scenes
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    def deep_scene(name):
        if name == "mesh_box":  # a closed box of triangles: kernel 1d-t
            return scenes.SceneDef(*probes.mesh_box(SceneBuilder, Camera))
        return scenes.get(name)

    gallery = tool("render_gallery_torch")
    out = {}
    with Phase("43 depth 50"):
        # kernel 1a's and 1d-t's chunk launch against the plain chunk
        for name in DEEP_CHUNK_SCENES:
            sd = deep_scene(name)
            st = RenderSettings(image_width=DEEP_WIDTH, aspect_ratio=sd.aspect,
                                spp_per_chunk=DEEP_SPP, num_chunks=1,
                                max_depth=DEEP_DEPTH, ray_batch=65536,
                                rr_start=DEEP_RR_START)
            chunk = compile_renderer(sd.scene, sd.camera, st, dev)
            got, counts = counted(lambda: chunk(base))
            h, w, b = st.image_height, st.image_width, _grid_geometry(st)[4]
            bake = cuda_trace.bake_scene(sd.scene)
            plain = cuda_trace.trace_chunk_reference(
                bake, sd.camera, h, w, base, DEEP_SPP, b, DEEP_DEPTH,
                st.t_min, dev, DEEP_RR_START)
            no_rr = cuda_trace.trace_chunk_reference(
                bake, sd.camera, h, w, base, DEEP_SPP, b, DEEP_DEPTH,
                st.t_min, dev)
            same = torch.equal(got, plain)
            rr_moved = not torch.equal(plain, no_rr)
            print(f"[depth50] {name} {w}x{h} {DEEP_SPP}spp depth "
                  f"{DEEP_DEPTH} rr_start {DEEP_RR_START} "
                  f"({chunk.engine_name}): chunk launch equal to the plain "
                  f"chunk on every row {same} (max abs err "
                  f"{float((got - plain).abs().max())}), launches {counts}, "
                  f"roulette moved the plain chunk {rr_moved}")
            if not (same and chunk.engine_name == "megakernel"
                    and rr_moved == (name not in DEEP_NO_RR)
                    and counts == dict(launches=1, record=0, record_chunk=0,
                                       ray=0, hit=0)):
                raise AssertionError(f"{name}: the depth-50 chunk launch "
                                     "disagrees with its plain version")
        for name in DEEP_GOLDENS:
            g = np.load(os.path.join(DATA, f"{name}_d50.npz"))
            gst = golden_settings(g)
            sd = deep_scene(name)
            gcmp = golden_cmp(compile_renderer(sd.scene, sd.camera, gst, dev)(
                int(g["base"])), torch.from_numpy(g["sums"]))
            print(f"[kernel-vs-jax-golden] {name} {gst.image_width}x"
                  f"{gst.image_height} {gst.spp_per_chunk}spp depth "
                  f"{gst.max_depth} rr_start {gst.rr_start}: {gcmp}")
            if not (gcmp["ok"] and gst.max_depth == DEEP_DEPTH):
                raise AssertionError(f"{name}: the depth-50 chunk disagrees "
                                     "with the JAX golden")
        rg = np.load(os.path.join(DATA, f"{BIG}_regen_d50.npz"))
        rst = golden_settings(rg)
        bsd = scenes.get(BIG)
        rsums, rstats = compile_regen_renderer(
            bsd.scene, bsd.camera, rst, debug_stats=True, device=dev)(20241)
        npix = rst.num_pixels
        z = z_scores(rsums.cpu().numpy()[:npix] / rst.spp_per_chunk,
                     rg["sums"][:npix] / rst.spp_per_chunk)
        ratio = rstats["iterations"] / int(rg["iterations"])
        print(f"[regen-vs-jax-golden] {BIG} {rst.image_width}x"
              f"{rst.image_height} {rst.spp_per_chunk}spp depth "
              f"{rst.max_depth} rr_start {rst.rr_start}: z {z}, steps "
              f"{rstats} against JAX's {int(rg['iterations'])}, stream "
              f"{int(rg['stream'])}")
        if not ((np.abs(z) < Z_LIMIT).all() and abs(ratio - 1) < 0.1
                and rstats["stream"] == int(rg["stream"])
                and rst.max_depth == DEEP_DEPTH):
            raise AssertionError("the depth-50 regen chunk disagrees with "
                                 "the JAX regen golden")

        # every gallery scene on its full-size route, one 16-spp chunk
        emap = probes.synthetic_image(*EARTH_MAP)
        sds = [(name, scenes.get(name), gallery.PLAN[name][0])
               for name in gallery.PLAN]
        sds.append(("earth (map)", scenes.earth(emap),
                    gallery.PLAN["earth"][0]))
        renders = {}
        for label, sd, width in sds:
            st = RenderSettings(image_width=width, aspect_ratio=sd.aspect,
                                spp_per_chunk=GALLERY_SPP, num_chunks=1,
                                max_depth=DEEP_DEPTH,
                                ray_batch=gallery.RAY_BATCH,
                                rr_start=gallery.RR_START)
            torch.cuda.synchronize()
            img, line = gallery.render_scene(sd, st, dev)
            regen = label in GALLERY_REGEN
            want = "regen" if regen else "megakernel"
            counts = line["launches"]
            # regen: one rt_hit launch a step of the render's own chunk
            kinds_ok = (counts == {"rt_hit": line["steps"]}
                        and line["steps"] > 0
                        if regen else counts == {"rt_trace_chunk": 1})
            mean = float(img.mean())
            print(f"[gallery depth50] {label}: {json.dumps(line)}, image "
                  f"mean {mean:.6f} on {card}")
            if not (line["engine"] == want and kinds_ok
                    and np.isfinite(img).all() and mean > LIT_MEAN):
                raise AssertionError(f"{label}: engine {line['engine']} "
                                     f"(want {want}), launches {counts}, "
                                     f"mean {mean}")
            renders[label] = dict(engine=line["engine"], launches=counts,
                                  mrays_per_s=line["mrays_per_s"],
                                  steps=line["steps"],
                                  peak_mib=line["peak_mib"])
        out["gallery"] = renders

        # the CLI's defaults on the Cornell box
        png = os.path.join(ROOT, "build", "chip_smoke_cli_cornell_box.png")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(["render", "cornell_box", "-o", png])
        wall = time.perf_counter() - t0
        counts = cuda_trace.launch_counts()
        pixels = film.read_png(png)
        (h, w, _), mean = pixels.shape, float(pixels.mean()) / 256.0
        c = CLI_DEFAULT
        rays = c["width"] * c["width"] * c["spp"] * c["chunks"]
        print(f"[cli default] render cornell_box {w}x{h} "
              f"{c['chunks']} x {c['spp']}spp depth {c['depth']}: exit {rc}, "
              f"{wall:.6f} s, {rays / wall / 1e6:.6f} Mrays/s, launches "
              f"{({k: v for k, v in counts.items() if v})}, image mean "
              f"{mean:.6f} on {card}")
        if not (rc == 0 and (h, w) == (c["width"], c["width"])
                and counts["rt_trace_chunk"] == c["chunks"]
                and sum(counts.values()) == c["chunks"] and mean > LIT_MEAN):
            raise AssertionError("the CLI's default render is off")
        out["cli"] = dict(launches=counts["rt_trace_chunk"],
                          mrays_per_s=rays / wall / 1e6)
    return out


def roofline_phase(card: str) -> list:
    """Phase 44: `tools/roofline_torch.py` run as a user runs it, in a
    process of its own (in this one, after the profiled runs of earlier
    phases, torch.profiler returns the windows of phases A, B and F
    empty): its lines, each finite, each north-star phase launching its
    hand kernel (C and D none) with a device time above 0 in which the
    profiler saw that kernel, the bf16 matmul rate within BF16_SHARE of
    the card's bf16 peak."""
    import math
    import subprocess

    with Phase("44 roofline tool"):
        run = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "roofline_torch.py")],
            cwd=ROOT, capture_output=True, text=True, timeout=ROOFLINE_S)
        sys.stdout.write(run.stdout)
        if run.returncode != 0:
            raise AssertionError(f"tools/roofline_torch.py exited "
                                 f"{run.returncode}: {run.stderr[-2000:]}")
        lines = [json.loads(x) for x in run.stdout.splitlines()
                 if x.startswith("{")]
        by = {line["measure"]: line for line in lines}
        for line in lines[1:]:
            nums = [v for k, v in line.items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)]
            if not all(math.isfinite(v) for v in nums) or not nums:
                raise AssertionError(f"roofline line not finite: {line}")
        for measure, kernel in ROOFLINE_KERNELS.items():
            line = by[measure]
            got = line["launches"]
            ok = (got == {} if kernel is None
                  else set(got) == {kernel} and got[kernel] > 0)
            # a device time the profiler measured: every phase runs
            # kernels, and the hand kernel's own launches were seen
            hand = line["hand_device_seconds"]
            timed = (line["device_seconds"] > 0
                     and (hand == 0 if kernel is None
                          else hand > 0 and line["hand_events"] > 0))
            if not (ok and timed and line["seconds"] > 0):
                raise AssertionError(
                    f"{measure}: launches {got} (want {kernel}), device "
                    f"seconds {line['device_seconds']}, hand kernels "
                    f"{hand} s in {line['hand_events']} events")
        share = by["mxu_bf16_matmul"]["peak_share"]
        print(f"[roofline] bf16 matmul {by['mxu_bf16_matmul']['tflops']:.3f}"
              f" TFLOP/s, {share:.6f} of the card's bf16 peak "
              f"{by['mxu_bf16_matmul']['peak_tflops']:.3f} on {card}; "
              f"e2e_chunk_fwd_bwd route {by['e2e_chunk_fwd_bwd']['route']}")
        if not BF16_SHARE[0] <= share <= BF16_SHARE[1]:
            raise AssertionError(f"bf16 rate at {share} of the card's peak")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--png", default=os.path.join(ROOT, "build",
                                                  "chip_smoke_cornell_512.png"))
    args = ap.parse_args()
    t_start = time.perf_counter()

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
    from raytracing_gpu_tpu_torch.engine import diff, fused_diff
    from raytracing_gpu_tpu_torch.engine.integrator import shade_packed
    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.ops import build, cuda_trace
    from raytracing_gpu_tpu_torch.utils import roofline

    # ---- 2. build ----
    with Phase("2 build"):
        res = build.build(force=True)
        build.load()
        build_log = res.log
        print(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}, "
              f"{len(build.sources())} sources in parallel: "
              f"{res.seconds:.2f} s -> {os.path.relpath(res.library, ROOT)}")
        for line in res.log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"[build] {line.strip()}")

    # ---- 3. RNG ----
    with Phase("3 rng"):
        for salt in RNG_SALTS:
            got = cuda_trace.pcg_uniform(RNG_SEED, RNG_LANES, salt, dev).cpu()
            want = cuda_trace.pcg_uniform(RNG_SEED, RNG_LANES, salt, "cpu")
            same = torch.equal(got, want)
            print(f"[rng] seed {RNG_SEED} salt {salt}: {RNG_LANES} lanes "
                  f"bit-exact={same}")
            if not same:
                raise AssertionError(f"device RNG differs at salt {salt}: "
                                     f"{int((got != want).sum())} lanes")

    # ---- 4. kernel 3 and the card's ceilings ----
    with Phase("4 ceilings"):
        x = torch.rand(roofline.FMA_ELEMENTS,
                       generator=torch.Generator().manual_seed(5)).to(dev)
        k = roofline.FMA_STEPS[1]
        fma_err = 0.0
        for steps in FMA_CHECK_STEPS + (k,):
            got = roofline.fma_chain(x, steps)
            want = roofline.fma_chain_reference(x, steps)
            err = float((got - want).abs().max())
            fma_err = max(fma_err, err)
            fma_ok = bool(torch.allclose(got, want, rtol=1e-5, atol=0.0))
            # below ~30 steps the chain has not converged: the plain chain
            # one step short must fail the same tolerance
            short_ok = steps == k or not torch.allclose(
                roofline.fma_chain_reference(x, steps - 1), want, rtol=1e-5,
                atol=0.0)
            print(f"[fma-vs-plain] {roofline.FMA_ELEMENTS} elements, {steps} "
                  f"steps: max abs err {err}, allclose rtol 1e-5 {fma_ok}"
                  + ("" if steps == k else
                     f", one step short fails it {short_ok}"))
            if not (fma_ok and short_ok):
                raise AssertionError(f"fma_chain disagrees with its plain "
                                     f"version at {steps} steps, or the "
                                     "tolerance cannot see a missing step")
        fma_plain_ms = event_ms(lambda r: roofline.fma_chain_reference(x, k),
                                reps=1)
        reset_counts()
        fma = roofline.fma_ceiling(dev)
        fma_launches = roofline.launches
        hbm = roofline.hbm_ceiling(dev)
        peaks = roofline.card_peaks(dev)
        Ceilings.flops = max(fma["flops_per_s"], peaks["flops_per_s"])
        Ceilings.bytes_per_s = max(hbm["bytes_per_s"], peaks["bytes_per_s"])
        fma_ms = fma["ms"][1]
        fma_ops = 2 * k * fma["elements"] + 4 * fma["elements"]
        fma_bound_ms, fma_bound_by = bound(fma_ops, 8 * fma["elements"])
        print(f"[ceiling] float32 FMA measured "
              f"{fma['flops_per_s'] / 1e12:.3f} TFLOP/s ({fma_launches} "
              f"launches), card peak {peaks['flops_per_s'] / 1e12:.3f} "
              f"(spec sheet {SPEC_FP32_FLOPS / 1e12:.0f}); memory read + "
              f"write measured {hbm['bytes_per_s'] / 1e12:.3f} TB/s, card "
              f"peak {peaks['bytes_per_s'] / 1e12:.3f} (spec sheet "
              f"{SPEC_BYTES_PER_S / 1e12:.2f}) on {card}: {fma}, {hbm}")
        print(f"[ceiling] every bound divides by "
              f"{Ceilings.flops / 1e12:.3f} TFLOP/s and "
              f"{Ceilings.bytes_per_s / 1e12:.3f} TB/s; the probe reaches "
              f"{fma['flops_per_s'] / Ceilings.flops:.3f} and "
              f"{hbm['bytes_per_s'] / Ceilings.bytes_per_s:.3f} of them")
        print(f"[time] fma_chain {fma['elements']} elements x {k} steps: "
              f"kernel {fma_ms:.6f} ms, plain {fma_plain_ms:.6f} ms, bound "
              f"{fma_bound_ms:.6f} ms by {fma_bound_by}")
        del x, got, want  # keep phase 12's peak-memory reading its own

    # ---- 5. kernel against its plain version on the card ----
    sd = scenes.get("cornell_box")
    tracer = cuda_trace.Tracer(sd.scene, dev)
    base = 414133122
    main_n, main_depth = 65536, 8
    with Phase("5 cornell forward vs plain"):
        check_scene_kernel(tracer, sd, base, "cornell")
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
            raise AssertionError("kernel disagrees with plain at the main "
                                 "shape")
        wave = tracer.bind(sd.camera, 512, 512, main_depth)

        def kernel_wave(r):
            return wave(main_n, main_n, cuda_trace.wave_seed(base, r, 1))

        kernel_ms = event_ms(kernel_wave, reps=50, hold_device=True)
        kernel_loop_ms = event_ms(kernel_wave, reps=50)
        # the plain version synchronizes once a bounce (its all-dead test),
        # so its time per call is host and device together
        plain_ms = event_ms(lambda r: cuda_trace.trace_pixels_reference(
            tracer.bake, sd.camera, 512, 512, main_n, main_n,
            cuda_trace.wave_seed(base, r, 1), max_depth=main_depth,
            device=dev), reps=3)
        print(f"[time] one wave of {main_n} rays, depth {main_depth}: kernel "
              f"{kernel_ms:.6f} ms on the device ({kernel_loop_ms:.6f} ms per "
              f"call in a Python loop), plain {plain_ms:.6f} ms, on {card}; "
              f"the solid-texture kernel before spheres and media took "
              f"{CORNELL_WAVE_MS_BEFORE} ms on an H100 80GB HBM3 at 700 W "
              "(PERF.md)")

    # ---- 6. kernel against the JAX golden ----
    with Phase("6 cornell forward vs golden"):
        g = np.load(GOLDEN)
        gst = golden_settings(g)
        golden_chunk = compile_renderer(sd.scene, sd.camera, gst, dev)
        gcmp = compare(golden_chunk(int(g["base"])),
                       torch.from_numpy(g["sums"]), gst.max_depth)
        print(f"[kernel-vs-jax-golden] cornell 32x32 2spp depth "
              f"{gst.max_depth}: {gcmp}")
        if not gcmp["ok"]:
            raise AssertionError("kernel disagrees with the JAX golden")

    # ---- 7. the serving path ----
    with Phase("7 cornell serving"):
        st = RenderSettings(image_width=512, aspect_ratio=1.0,
                            spp_per_chunk=16, num_chunks=4, max_depth=8,
                            ray_batch=65536)
        serving = render_counted(sd, st, dev, card, "cornell_box", args.png)
        launches = serving["launches"]
        pst = st.with_(num_chunks=1)
        h, w, b = st.image_height, st.image_width, st.ray_batch
        nb = st.num_pixels // b
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(pst.spp_per_chunk):
            for bid in range(nb):
                cuda_trace.trace_pixels_reference(
                    tracer.bake, sd.camera, h, w, bid * b, b,
                    cuda_trace.wave_seed(base, s, bid),
                    max_depth=pst.max_depth, device=dev)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        plain_rays = pst.num_pixels * pst.spp_per_chunk
        print(f"[main] plain version, one 16-spp chunk: {plain_wall:.3f} s, "
              f"{plain_rays / plain_wall / 1e6:.2f} Mrays/s on {card}")

    # ---- 8. record kernel against its plain version on the card ----
    with Phase("8 cornell record vs plain"):
        for depth in (1, 8):
            got, want = [], []
            for s in range(4):
                seed = cuda_trace.wave_seed(base, s, 0)
                got.append(tracer.walk_packed_pixels(
                    sd.camera, 64, 64, 0, 4096, seed, max_depth=depth)[0])
                want.append(cuda_trace.walk_packed_pixels_reference(
                    tracer.bake, sd.camera, 64, 64, 0, 4096, seed,
                    max_depth=depth, device=dev)[0])
            torch.cuda.synchronize()
            rcmp = record_cmp(torch.stack(got), torch.stack(want))
            print(f"[record-vs-plain] cornell 64x64 4spp depth {depth}: "
                  f"{rcmp}")
            if not rcmp["ok"]:
                raise AssertionError(f"record kernel disagrees with plain at "
                                     f"depth {depth}")

        rec_n, rec_base = bench_torch.RAY_BATCH, bench_torch.RAY_BATCH
        rec_seed = cuda_trace.wave_seed(base, 0, 1)
        rec_plane = tracer.walk_packed_pixels(sd.camera, 512, 512, rec_base,
                                              rec_n, rec_seed,
                                              max_depth=main_depth)[0]
        rec_cmp = record_cmp(rec_plane,
                             cuda_trace.walk_packed_pixels_reference(
                                 tracer.bake, sd.camera, 512, 512, rec_base,
                                 rec_n, rec_seed, max_depth=main_depth,
                                 device=dev)[0])
        print(f"[record-vs-plain] main shape 512x512 wave of {rec_n} depth "
              f"{main_depth}: {rec_cmp}")
        if not rec_cmp["ok"]:
            raise AssertionError("record kernel disagrees with plain at the "
                                 "main shape")
        rec_wave = tracer.bind_record(sd.camera, 512, 512, main_depth)

        def record_wave(r):
            return rec_wave(rec_base, rec_n, cuda_trace.wave_seed(base, r, 1))

        rec_ms = event_ms(record_wave, reps=50, hold_device=True)
        rec_loop_ms = event_ms(record_wave, reps=50)
        rec_plain_ms = event_ms(
            lambda r: cuda_trace.walk_packed_pixels_reference(
                tracer.bake, sd.camera, 512, 512, rec_base, rec_n,
                cuda_trace.wave_seed(base, r, 1), max_depth=main_depth,
                device=dev)[0], reps=3)
        print(f"[time] record kernel, one wave of {rec_n} rays, depth "
              f"{main_depth}: {rec_ms:.6f} ms on the device ({rec_loop_ms:.6f}"
              f" ms per call in a Python loop), plain {rec_plain_ms:.6f} ms, "
              f"on {card}")

        # bounds from the live bounces of each kernel's main-shape wave
        tbytes = table_bytes(tracer)
        live, cont = live_counts(rec_plane)
        rec_ops = (rec_n * OPS_CAMERA + live * (6 * OPS_RECT + 2 * OPS_BOX + 1)
                   + cont * OPS_SCATTER[0])
        rec_bytes = 4 * main_depth * rec_n + tbytes
        rec_bound_ms, rec_bound_by = bound(rec_ops, rec_bytes)
        print(f"[bound] record wave: {live} live, {cont} continued bounces of "
              f"{rec_n} rays -> {rec_bound_ms:.6f} ms, bound by "
              f"{rec_bound_by} ({spec_bound_ms(rec_ops, rec_bytes):.6f} ms "
              "over the spec sheet)")
        fwd_plane = tracer.walk_packed_pixels(
            sd.camera, 512, 512, main_n, main_n,
            cuda_trace.wave_seed(base, 0, 1), max_depth=main_depth)[0]
        fwd_ops = wave_ops(tracer.bake, plane_counts(sd.scene, fwd_plane),
                           main_n)
        fwd_bound_ms, fwd_bound_by = bound(fwd_ops, 12 * main_n + tbytes)
        fwd_live, fwd_cont = live_counts(fwd_plane)
        print(f"[bound] forward wave: {fwd_live} live, {fwd_cont} continued "
              f"bounces of {main_n} rays -> {fwd_bound_ms:.6f} ms, bound by "
              f"{fwd_bound_by} "
              f"({spec_bound_ms(fwd_ops, 12 * main_n + tbytes):.6f} ms over "
              "the spec sheet)")

    # ---- 9. record kernel against the JAX golden ----
    with Phase("9 cornell record vs golden"):
        gg = np.load(GRAD_GOLDEN)
        gst = golden_settings(gg)
        gh, gw, gb = gst.image_height, gst.image_width, gst.ray_batch
        gbase = int(gg["base"])
        gwaves = [(s, bid) for s in range(gst.spp_per_chunk)
                  for bid in range(gh * gw // gb)]
        got = torch.stack([tracer.walk_packed_pixels(
            sd.camera, gh, gw, bid * gb, gb,
            cuda_trace.wave_seed(gbase, s, bid), max_depth=gst.max_depth,
            t_min=gst.t_min)[0] for s, bid in gwaves])
        jcmp = cuda_trace.record_agreement(got, gg["planes"])
        print(f"[record-vs-jax-golden] cornell 32x32 2spp depth "
              f"{gst.max_depth}, {len(gwaves)} waves: {jcmp}")
        if not (jcmp["first_bounce"] and jcmp["lane_frac"] >= LANE_FLOOR):
            raise AssertionError("record kernel disagrees with the JAX golden")

    # ---- 10. the two modes agree ----
    with Phase("10 modes agree"):
        params = diff.get_params(sd.scene, dev)
        shaded = shade_packed(sd.scene, params, rec_plane, need_p=False,
                              need_uv=False)
        fwd = tracer.trace_pixels(sd.camera, 512, 512, rec_base, rec_n,
                                  rec_seed, max_depth=main_depth)
        mcmp = compare(shaded, fwd, main_depth)
        print(f"[modes] shade_packed(record) vs forward kernel, 512x512 wave "
              f"of {rec_n} depth {main_depth}: {mcmp}")
        if not mcmp["ok"]:
            raise AssertionError("record and forward modes disagree")

    # ---- 11. fused chunk against the golden and the plain walk ----
    with Phase("11 fused chunk"):
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
        plain_out, plain_grads = value_and_grad(
            fused_diff.fused_chunk_from_walk(
                sd.scene,
                lambda pb, n, seed: cuda_trace.walk_packed_pixels_reference(
                    tracer.bake, sd.camera, gh, gw, pb, n, seed,
                    gst.max_depth, gst.t_min, dev), gst, device=dev))
        for what, out, grads in (
                ("jax-golden", torch.from_numpy(gg["primal"]), want_grads),
                ("plain-on-card", plain_out, plain_grads)):
            pcmp = compare(fused_out, out, gst.max_depth)
            gcmp = grad_cmp(fused_grads, grads)
            print(f"[fused-vs-{what}] cornell 32x32 2spp depth "
                  f"{gst.max_depth}: primal {pcmp}, gradients {gcmp}")
            if not (pcmp["ok"] and gcmp["ok"]):
                raise AssertionError(f"fused chunk disagrees with the {what}")

    # ---- 12. the training path ----
    with Phase("12 training"):
        tst = bench_torch.settings()
        tchunk = fused_diff.compile_fused_param_renderer(sd.scene, sd.camera,
                                                         tst, device=dev)
        gen = torch.Generator().manual_seed(bench_torch.SEED)
        target = torch.zeros_like(tchunk(params, cuda_trace.chunk_seed(gen)))
        bench_torch.train_renders(tchunk, params, target,
                                  [cuda_trace.chunk_seed(gen)])  # warm-up
        tbases = [cuda_trace.chunk_seed(gen) for _ in range(tst.num_chunks)]
        # one record launch a chunk (planes kept for the backward pass);
        # before the chunk launch, one a (sample, wave): 8 x 8 x 8 = 512
        t_waves = (tst.num_chunks * tst.spp_per_chunk
                   * (tst.num_pixels // tst.ray_batch))
        t_expected = tst.num_chunks
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        loss, grads = bench_torch.train_renders(tchunk, params, target, tbases)
        torch.cuda.synchronize()
        t_wall = time.perf_counter() - t0
        t_launches = cuda_trace.Tracer.record_chunk_launches
        t_stray = forward_launches() + cuda_trace.Tracer.record_launches
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        t_rays = tst.num_pixels * tst.rays_per_pixel
        t_mrays = t_rays / t_wall / 1e6
        print(f"[train] fwd+bwd cornell_box 512x512 64spp depth 8, ray_batch "
              f"{tst.ray_batch}, save_planes {tchunk.save_planes}: "
              f"{t_wall:.6f} s, {t_mrays:.6f} Mrays/s, record chunk "
              f"launches {t_launches} (expected {t_expected}, for "
              f"{t_waves} waves), per-wave record and forward launches "
              f"{t_stray}, peak allocated {peak_mb:.3f} MiB on {card}")
        if t_launches != t_expected or t_stray != 0 or not tchunk.save_planes:
            raise AssertionError(f"{t_launches} record chunk and {t_stray} "
                                 f"other kernel launches, expected "
                                 f"{t_expected} and 0")
        if not (bool(torch.isfinite(loss)) and float(loss) > 0.0
                and all(bool(torch.isfinite(g).all()) for g in grads.values())
                and float(grads["tex_c1"].abs().max()) > 0.0):
            raise AssertionError(f"bad loss {float(loss)} or gradients")
        print(f"[train] summed loss {float(loss):.9g}, tex_c1 gradient "
              f"{grads['tex_c1'].cpu().numpy().tolist()}")
        tprof = device_busy(lambda: bench_torch.train_renders(
            tchunk, params, target, tbases))
        t_busy = tprof["device_ms"] / (t_wall * 1e3)
        top = sorted(tprof["by_kernel"].items(), key=lambda kv: -kv[1][0])[:12]
        print(f"[train] profiled repeat: device {tprof['device_ms']:.3f} ms, "
              f"wall {tprof['wall_ms']:.3f} ms; top kernels (ms, count) {top}")
        print(f"[train] device busy share of the counted render: "
              f"{t_busy:.6f} ({tprof['device_ms']:.3f} ms of device time in "
              f"{t_wall * 1e3:.3f} ms)")

    # ---- 13. the dense scenes: kernel vs plain, then vs the JAX golden ----
    tracers = {}
    with Phase("13 dense scenes forward"):
        for name in DENSE_SCENES:
            dsd = scenes.get(name)
            tracers[name] = (dsd, cuda_trace.Tracer(dsd.scene, dev))
            check_scene_kernel(tracers[name][1], dsd, base, name)
            g = np.load(os.path.join(DATA, f"{name}_32.npz"))
            gst = golden_settings(g)
            got = compile_renderer(dsd.scene, dsd.camera, gst, dev)(
                int(g["base"]))
            gcmp = golden_cmp(got, torch.from_numpy(g["sums"]))
            print(f"[kernel-vs-jax-golden] {name} {gst.image_width}x"
                  f"{gst.image_height} 2spp depth {gst.max_depth}: {gcmp}")
            if not gcmp["ok"]:
                raise AssertionError(f"{name}: kernel disagrees with the JAX "
                                     "golden")

    # ---- 14. record mode on the solid dense scenes ----
    with Phase("14 dense scenes record"):
        for name in RECORD_SCENES:
            dsd, dtr = tracers[name]
            got = torch.stack([dtr.walk_packed_pixels(
                dsd.camera, 64, 64, 0, 4096, cuda_trace.wave_seed(base, s, 0),
                max_depth=8)[0] for s in range(4)])
            want = torch.stack([cuda_trace.walk_packed_pixels_reference(
                dtr.bake, dsd.camera, 64, 64, 0, 4096,
                cuda_trace.wave_seed(base, s, 0), 8, device=dev)[0]
                for s in range(4)])
            rcmp = record_cmp(got, want)
            print(f"[record-vs-plain] {name} 64x64 4spp depth 8: {rcmp}")
            if not rcmp["ok"]:
                raise AssertionError(f"{name}: record kernel disagrees with "
                                     "plain")
            g = np.load(os.path.join(DATA, f"{name}_32.npz"))
            gst = golden_settings(g)
            gb = int(g["record_ray_batch"])
            gh, gw = gst.image_height, gst.image_width
            got = torch.stack([dtr.walk_packed_pixels(
                dsd.camera, gh, gw, bid * gb, gb,
                cuda_trace.wave_seed(int(g["base"]), s, bid),
                gst.max_depth, gst.t_min)[0]
                for s in range(gst.spp_per_chunk)
                for bid in range(-(-gh * gw // gb))])
            jcmp = cuda_trace.record_agreement(got, g["planes"])
            print(f"[record-vs-jax-golden] {name} {gw}x{gh} 2spp depth "
                  f"{gst.max_depth}: {jcmp}")
            if not (jcmp["first_bounce"] and jcmp["lane_frac"] >= LANE_FLOOR):
                raise AssertionError(f"{name}: record kernel disagrees with "
                                     "the JAX golden")

    # ---- 15, 16. BASELINE configs 1 and 4 ----
    configs = {}
    for phase, cfg, name, width, spp, chunks, depth in BASELINE:
        with Phase(f"{phase} BASELINE config {cfg}"):
            dsd, dtr = tracers[name]
            cst = RenderSettings(image_width=width, aspect_ratio=dsd.aspect,
                                 spp_per_chunk=spp, num_chunks=chunks,
                                 max_depth=depth, ray_batch=65536)
            png = os.path.join(os.path.dirname(os.path.abspath(args.png)),
                               f"chip_smoke_{name}_{width}.png")
            configs[name] = render_counted(dsd, cst, dev, card,
                                           f"{name} (config {cfg})", png)
            configs[name].update(time_wave(dtr, dsd, cst, base, card,
                                           f"{name} (config {cfg})"))
            print(f"[config {cfg}] {name}: {configs[name]}")

    # ---- 17. russian roulette ----
    with Phase("17 russian roulette"):
        name, width, spp, depth, rr_start = RR_RENDER
        dsd, dtr = tracers[name]
        seed = cuda_trace.wave_seed(base, 0, 1)
        rr_wave = dtr.trace_pixels(dsd.camera, width, width, 0, 65536, seed,
                                   max_depth=depth, rr_start=rr_start)
        rr_cmp = compare(rr_wave, cuda_trace.trace_pixels_reference(
            dtr.bake, dsd.camera, width, width, 0, 65536, seed, depth,
            device=dev, rr_start=rr_start), depth)
        rr_moved = not torch.equal(rr_wave, dtr.trace_pixels(
            dsd.camera, width, width, 0, 65536, seed, max_depth=depth))
        print(f"[kernel-vs-plain] {name} wave of 65536 rays, depth {depth}, "
              f"rr_start {rr_start}: {rr_cmp}; differs from the wave without "
              f"russian roulette {rr_moved}")
        if not (rr_cmp["ok"] and rr_moved):
            raise AssertionError("russian roulette kernel disagrees with "
                                 "plain, or did not run")
        rst = RenderSettings(image_width=width, aspect_ratio=dsd.aspect,
                             spp_per_chunk=spp, num_chunks=1,
                             max_depth=depth, ray_batch=65536)
        t0 = time.perf_counter()
        plain_img = render(dsd.scene, dsd.camera, rst, device=dev)
        t1 = time.perf_counter()
        rr_img = render(dsd.scene, dsd.camera, rst.with_(rr_start=rr_start),
                        device=dev)
        t2 = time.perf_counter()
        rr_rel = abs(float(rr_img.mean()) / float(plain_img.mean()) - 1.0)
        print(f"[rr] {name} {width}x{width} {spp}spp depth {depth}: mean "
              f"{rr_img.mean():.6f} with rr_start {rr_start}, "
              f"{plain_img.mean():.6f} without (relative difference "
              f"{rr_rel:.6f}); render {t2 - t1:.6f} s with russian "
              f"roulette, {t1 - t0:.6f} s without, on {card}")
        if not (np.isfinite(rr_img).all() and rr_rel <= RR_MEAN_TOL):
            raise AssertionError("russian roulette render is off")

    big_mega, hit_row = big_scene1_phases(dev, card, base, args.png)
    tri_rows = triangle_phases(dev, card, base, args.png)
    train_rows, mesh_grad = training_phases(dev, card, base)
    tri_rows[1].update(mesh_grad)  # the mesh-grad route runs rt_hit<tri>
    uv_row, map_rates = image_phases(dev, card, base,
                                     tri_rows[1]["config5_steps"])
    tri_rows[1].update(map_rates)  # config 5 with its map runs rt_hit<tri>

    # ---- 37. whole chunks: one chunk launch against the per-wave ones ----
    with Phase("37 whole chunks"):
        chunks = {}
        for label, name, width, spp, depth in CHUNKS:
            csd = scenes.get(name)
            cst = RenderSettings(image_width=width, aspect_ratio=csd.aspect,
                                 spp_per_chunk=spp, num_chunks=1,
                                 max_depth=depth, ray_batch=65536)
            chunks[label] = time_chunk(csd, cst, base, card, label)
    for row, label in ((tri_rows[0], "triangles"), ):
        row.update({f"{label}_{k}": v for k, v in chunks[label].items()})
    with Phase("38 whole training chunks"):
        rchunks = {}
        for label, name, width, spp, depth, batch in TRAIN_CHUNKS:
            rsd = scenes.get(name)
            rst = RenderSettings(image_width=width, aspect_ratio=rsd.aspect,
                                 spp_per_chunk=spp, num_chunks=1,
                                 max_depth=depth, ray_batch=batch)
            rchunks[label] = time_record_chunk(rsd, rst, base, card, label,
                                               build_log)
        tri_rows[0].update(time_backpack_chunk(card, base, build_log))
        tri_rows[0]["triangles_registers"] = kernel_registers(
            build_log, "megakernel_fwd",
            cuda_trace.bake_scene(scenes.get("triangles").scene).features())
    xla_phases(dev, card, base)
    par = parallel_phases(dev, card, base)
    deep = deep_phases(dev, card, base)
    roof = roofline_phase(card)
    hit_row["sharded_launches"] = dict(par["regen"],
                                       world1=par["world1"]["regen"])
    train_rows[3]["sharded_launches"] = par["megakernel"]
    chunk_fields(train_rows[0], rchunks[BIG])
    chunk_fields(train_rows[1], rchunks["triangles"])
    record_row = {
        "name": "megakernel_record (rt_walk_chunk)", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES, "launches": t_launches,
        "exact_frac": rec_cmp["exact_frac"], "library_ms": None,
        "wave_ms": rec_ms, "wave_plain_ms": rec_plain_ms,
        "wave_bound_ms": rec_bound_ms, "wave_bound_by": rec_bound_by,
        "wave_max_abs_err": rec_cmp["max_abs_err"],
        "wave_loop_ms": rec_loop_ms,
        "train_mrays_per_s": t_mrays,
        "train_device_busy_share": t_busy,
        "train_peak_allocated_mib": peak_mb,
        "sharded_launches": dict(par["train"],
                                 world1=par["world1"]["train"])}
    chunk_fields(record_row, rchunks["Cornell"])

    scene_rates = {name: dict(c) for name, c in configs.items()}
    cornell = chunks["Cornell"]
    print(json.dumps({"kernels": [{
        "name": "megakernel_fwd (rt_trace_chunk)", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES, "launches": launches,
        "max_abs_err": cornell["chunk_max_abs_err"],
        "ms": cornell["chunk_ms"], "plain_ms": cornell["chunk_plain_ms"],
        "bound_ms": cornell["chunk_bound_ms"],
        "bound_by": cornell["chunk_bound_by"],
        "library_ms": None,
        "loop_ms": cornell["chunk_loop_ms"],
        "chunks": chunks,
        "wave_ms": kernel_ms, "wave_plain_ms": plain_ms,
        "wave_bound_ms": fwd_bound_ms, "wave_bound_by": fwd_bound_by,
        "wave_max_abs_err": main_cmp["max_abs_err"],
        "wave_loop_ms": kernel_loop_ms,
        "render_mrays_per_s": serving["mrays_per_s"],
        "render_device_busy_share": serving["busy_share"],
        "profiled_render_busy_share": serving["profiled_busy_share"],
        "plain_chunk_mrays_per_s": plain_rays / plain_wall / 1e6,
        "scenes": scene_rates, "depth50": deep}, record_row, {
        "name": "megakernel_fwd<sphere_bvh> (rt_trace_chunk)",
        "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": big_mega["launches"],
        "max_abs_err": chunks[BIG]["chunk_max_abs_err"],
        "ms": chunks[BIG]["chunk_ms"],
        "plain_ms": chunks[BIG]["chunk_plain_ms"],
        "bound_ms": chunks[BIG]["chunk_bound_ms"],
        "bound_by": chunks[BIG]["chunk_bound_by"],
        "library_ms": None,
        "loop_ms": chunks[BIG]["chunk_loop_ms"],
        "waves_ms": chunks[BIG]["waves_ms"],
        "wave_ms": big_mega["ms"], "wave_plain_ms": big_mega["plain_ms"],
        "wave_bound_ms": big_mega["bound_ms"],
        "wave_max_abs_err": big_mega["max_abs_err"],
        "wave_exact_frac": big_mega["exact_frac"],
        "render_mrays_per_s": big_mega["mrays_per_s"],
        "render_device_busy_share": big_mega["busy_share"]}, hit_row,
        *tri_rows, *train_rows, uv_row, {
        "name": "fma_chain", "route": "cuda", "source": FMA_SOURCE,
        "replaces": FMA_REPLACES, "launches": fma_launches,
        "max_abs_err": fma_err, "ms": fma_ms, "plain_ms": fma_plain_ms,
        "bound_ms": fma_bound_ms, "bound_by": fma_bound_by,
        "library_ms": None,
        "fma_tflops": fma["flops_per_s"] / 1e12,
        "memory_tb_per_s": hbm["bytes_per_s"] / 1e12,
        "roofline_tool": {line["measure"]: {
            k: v for k, v in line.items() if k != "measure"}
            for line in roof}}]}))
    print(f"[done] {time.perf_counter() - t_start:.2f} s")
    print(card)  # name, power limit: nvidia-smi's own line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
