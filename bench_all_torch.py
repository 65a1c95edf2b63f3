#!/usr/bin/env python3
"""The BASELINE workloads of `bench_all.py` on the PyTorch + CUDA port, on
one CUDA card: one JSON line per result.

    python3 bench_all_torch.py                      # configs 1-5 and 5-rr
    python3 bench_all_torch.py --spp-scale 8        # 1/8 of the spp
    python3 bench_all_torch.py --earth-grad --mesh-grad --json-out out.json

Configs (`bench_all.py:430-447`; the reference's depth is 50, these are
`bench_all.py`'s):

  1    first          400x225   16 spp  depth 8   forward
  2    big_scene1     800x450   32 spp  depth 16  forward
  3    cornell_box    512x512   64 spp  depth 8   fwd+bwd (bench_torch.py)
  4    cornell_smoke  512x512  128 spp  depth 16  forward
  5    backpack       800x600  256 spp  depth 16  forward, waves of 131,072
  5-rr the same with russian roulette from bounce 2

`--earth-grad` adds the earth atlas-gradient row (256x256, 8 spp, depth 8)
on a synthetic 1024x512 map (`models.probes.synthetic_image`: the earthmap
is not in the repository), `--mesh-grad` the backpack gradient row
(800x600, 4 spp, depth 8, the wavefront-record route).  A forward config
takes `bench_all.py`'s chunking (`forward_settings`): up to 4 chunks of at
least 16 spp where the spp allow, so the regen route stays eligible.

Timing: one warm-up render (the kernel build and the first launches), one
timed render that sets the repetitions (short workloads repeat to fill
about 0.5 s, as `bench_all._time_program` does), then the median of 3
trials of those repetitions, each between `torch.cuda.synchronize()`
points on the host clock.  Every chunk of every render draws its own base
seed.  Each row has `bench_all.py`'s keys plus the card's name (`device`)
and power limit (`power_limit`, from nvidia-smi).  A workload that fails
prints an error row, and the script then exits 1.  Exits non-zero, with
no result line, when no CUDA device is available.

`--scaling` adds `bench_all.py`'s scaling rows (:257-301): `first`
(400x225, 8 spp, or 8 * dp under `--weak`, depth 8, waves of 8,192) on
dp = 1, 2, 4, 8 ranks of a world of one rank a card, up to its size,
each chunk through `parallel.render.compile_sharded_renderer`; and its
shard-overhead rows (:304-378): the ms of one `all_reduce` of a
(512*512/2, 3) float32 array over the sp group of a mesh of every rank,
and the chunk of a tiny workload (64 wide, 1 spp, depth 2) on each dp.
`--cpu-mesh N` runs those rows alone on N gloo ranks of the CPU (the
kernels' plain versions: it checks the harness, and measures no card).
A row from ranks that share a card says so (`shared_card`): it is not
scaling across cards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1984
TIME_FILL_S = 0.5   # short workloads repeat to fill this much wall time
MAX_REPS = 32
EARTH_MAP = (512, 1024, 7)   # the synthetic earthmap: height, width, seed

# name, width, aspect, declared spp, depth, ray_batch, rr_start
FORWARD = {
    "1": ("first", 400, 16 / 9, 16, 8, 65536, 0),
    "2": ("big_scene1", 800, 16 / 9, 32, 16, 65536, 0),
    "4": ("cornell_smoke", 512, 1.0, 128, 16, 65536, 0),
    "5": ("backpack", 800, 4 / 3, 256, 16, 131072, 0),
    "5-rr": ("backpack", 800, 4 / 3, 256, 16, 131072, 2),
}


def forward_settings(width: int, aspect: float, spp: int, depth: int,
                     spp_scale: int, ray_batch: int = 65536,
                     rr_start: int = 0):
    """`bench_all.bench_forward`'s settings (:100-127): the declared spp
    over `spp_scale`, as up to 4 chunks of at least 16 spp where the spp
    allow."""
    from raytracing_gpu_tpu_torch import RenderSettings

    spp_run = max(1, spp // spp_scale)
    chunks = max(1, min(4, spp_run // 16 or spp_run))
    return RenderSettings(image_width=width, aspect_ratio=aspect,
                          spp_per_chunk=max(1, spp_run // chunks),
                          num_chunks=chunks, max_depth=depth,
                          ray_batch=ray_batch, rr_start=rr_start)


def train_settings(spp_scale: int):
    """Config 3's settings (`bench_all.bench_fwd_bwd`, :128-165):
    `bench_torch.py`'s workload with max(8, 64 / spp_scale) spp."""
    import bench_torch

    st = bench_torch.settings()
    return st.with_(num_chunks=max(8, 64 // spp_scale) // st.spp_per_chunk)


def grad_settings(which: str):
    """The earth-grad (:168-210) and mesh-grad (:213-254) rows' settings:
    256x256, 8 spp, depth 8 and 800x600, 4 spp, depth 8."""
    from raytracing_gpu_tpu_torch import RenderSettings

    if which == "earth":
        return RenderSettings(image_width=256, aspect_ratio=1.0,
                              spp_per_chunk=8, num_chunks=1, max_depth=8,
                              ray_batch=65536)
    return RenderSettings(image_width=800, aspect_ratio=4 / 3,
                          spp_per_chunk=4, num_chunks=1, max_depth=8,
                          ray_batch=65536)


def rays(st) -> int:
    return st.num_pixels * st.spp_per_chunk * st.num_chunks


def forward_row(name: str, st, spp_declared: int, seconds: float,
                engine: str) -> dict:
    """`bench_forward`'s row."""
    row = dict(scene=name, mode="forward",
               shape=f"{st.image_width}x{st.image_height}",
               spp=st.rays_per_pixel, spp_declared=spp_declared,
               depth=st.max_depth, seconds=seconds,
               mrays_per_s=rays(st) / seconds / 1e6, engine=engine)
    if st.rr_start:
        row["rr_start"] = st.rr_start
    return row


def train_row(st, seconds: float) -> dict:
    """`bench_fwd_bwd`'s row."""
    return dict(scene="cornell_box", mode="fwd+bwd",
                shape=f"{st.image_width}x{st.image_height}",
                spp=st.rays_per_pixel, spp_declared=64, depth=st.max_depth,
                seconds=seconds, mrays_per_s=rays(st) / seconds / 1e6)


def grad_row(which: str, st, seconds: float, engine: str) -> dict:
    """The earth-grad and mesh-grad rows."""
    row = dict(scene="earth" if which == "earth" else "backpack",
               mode=("fwd+bwd+atlas-grads" if which == "earth"
                     else "fwd+bwd+mesh-grads"),
               shape=f"{st.image_width}x{st.image_height}",
               spp=st.rays_per_pixel, depth=st.max_depth, seconds=seconds,
               mrays_per_s=rays(st) / seconds / 1e6)
    if which == "mesh":
        row["engine"] = engine
    return row


def time_program(run) -> float:
    """Seconds of one `run()` (a whole workload, every chunk with its own
    bases): a warm-up, one timed run that sets how many runs fill about
    TIME_FILL_S, then the median of 3 synchronized trials of that many,
    over their count."""
    import torch

    def timed(reps: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed(1)
    reps = max(1, min(MAX_REPS, int(TIME_FILL_S / max(timed(1), 1e-3))))
    return sorted(timed(reps) for _ in range(3))[1] / reps


def bench_forward(key: str, spp_scale: int, dev) -> dict:
    import torch

    from raytracing_gpu_tpu_torch import compile_renderer
    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    name, width, aspect, spp, depth, batch, rr = FORWARD[key]
    st = forward_settings(width, aspect, spp, depth, spp_scale, batch, rr)
    sd = scenes.get(name)
    chunk = compile_renderer(sd.scene, sd.camera, st, dev)
    gen = torch.Generator().manual_seed(SEED)

    def run():
        acc = torch.zeros((), device=dev)
        for _ in range(st.num_chunks):
            acc = acc + chunk(cuda_trace.chunk_seed(gen)).sum()
        if not bool(torch.isfinite(acc)):
            raise AssertionError(f"config {key}: non-finite sums")

    return forward_row(name, st, spp, time_program(run), chunk.engine_name)


def _train_run(chunk, params, target, nbases: int):
    import torch

    import bench_torch
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    gen = torch.Generator().manual_seed(SEED)

    def run():
        bases = [cuda_trace.chunk_seed(gen) for _ in range(nbases)]
        loss, grads = bench_torch.train_renders(chunk, params, target, bases)
        if not (torch.isfinite(loss) and all(torch.isfinite(g).all()
                                             for g in grads.values())):
            raise AssertionError("non-finite loss or gradient")

    return run


def bench_fwd_bwd(spp_scale: int, dev) -> dict:
    """Config 3: `bench_torch.py`'s workload through its own
    `train_renders`."""
    import torch

    from raytracing_gpu_tpu_torch.engine import diff
    from raytracing_gpu_tpu_torch.engine.fused_diff import (
        compile_fused_param_renderer)
    from raytracing_gpu_tpu_torch.models import scenes

    st = train_settings(spp_scale)
    sd = scenes.get("cornell_box")
    chunk = compile_fused_param_renderer(sd.scene, sd.camera, st, device=dev)
    params = diff.get_params(sd.scene, dev)
    target = torch.zeros_like(chunk(params, SEED))
    return train_row(st, time_program(_train_run(chunk, params, target,
                                                 st.num_chunks)))


def bench_grad(which: str, dev) -> dict:
    """The earth-grad or mesh-grad row: `compile_param_renderer`, the L2
    loss against a zero target and its gradients, one chunk a render."""
    import torch

    from raytracing_gpu_tpu_torch.engine import diff
    from raytracing_gpu_tpu_torch.engine.render import compile_param_renderer
    from raytracing_gpu_tpu_torch.models import probes, scenes

    sd = (scenes.earth(probes.synthetic_image(*EARTH_MAP))
          if which == "earth" else scenes.get("backpack"))
    st = grad_settings(which)
    chunk = compile_param_renderer(sd.scene, sd.camera, st, device=dev)
    params = diff.get_params(sd.scene, dev)
    target = torch.zeros_like(chunk(params, SEED))
    leaf = "atlas_data" if which == "earth" else "tex_c1"
    _, grads = diff.value_and_grad(params, lambda p: chunk(p, SEED), target)
    if not bool((grads[leaf] != 0).any()):
        raise AssertionError(f"{which}-grad: the {leaf} gradient is zero")
    seconds = time_program(_train_run(chunk, params, target, 1))
    return grad_row(which, st, seconds, chunk.engine_name)


# bench_all.py:276-279, :336-337, :360-366
SCALING = dict(scene="first", width=400, aspect=16 / 9, spp=8, depth=8,
               ray_batch=8192)
TINY = dict(scene="first", width=64, aspect=16 / 9, spp=1, depth=2,
            ray_batch=1024)
SCALING_DPS = (1, 2, 4, 8)
PSUM_ROWS = 512 * 512 // 2
PSUM_REPS = (8, 32)


def scaling_rank(device, weak: bool = False, scaling: dict = SCALING,
                 tiny: dict = TINY) -> list:
    """One rank of the `--scaling` world (every rank calls it): the scaling
    rows, then the shard-overhead rows, timed on rank 0 between barriers
    of the world.  Returns the rows (rank 0's are the measured ones)."""
    import torch
    import torch.distributed as dist

    from raytracing_gpu_tpu_torch import RenderSettings
    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.parallel.mesh import make_mesh
    from raytracing_gpu_tpu_torch.parallel.render import (
        compile_sharded_renderer)
    from raytracing_gpu_tpu_torch.utils.profiling import synchronize

    world = dist.get_world_size() if dist.is_initialized() else 1
    backend = dist.get_backend() if dist.is_initialized() else "none"
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    label = dict(backend=backend, shared_card=0 < cards < world)

    def barrier():
        synchronize(device)
        if world > 1:
            dist.barrier()

    def timed(run, reps: int) -> float:
        barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        barrier()
        return time.perf_counter() - t0

    def settings(shape: dict, spp: int):
        return RenderSettings(image_width=shape["width"],
                              aspect_ratio=shape["aspect"],
                              spp_per_chunk=spp, num_chunks=1,
                              max_depth=shape["depth"],
                              ray_batch=shape["ray_batch"])

    def chunk_seconds(shape: dict, spp: int, dp: int, reps: int) -> tuple:
        st = settings(shape, spp)
        mesh = make_mesh(1, dp, ranks=range(dp))   # every rank makes groups
        sd = scenes.get(shape["scene"])
        run = lambda: None                          # noqa: E731
        if mesh.member:
            chunk = compile_sharded_renderer(sd.scene, sd.camera, st, mesh,
                                             device=device)
            run = lambda: chunk(7)                  # noqa: E731
        timed(run, 1)                               # warm-up
        return st, timed(run, reps) / reps

    rows, base = [], None
    for dp in SCALING_DPS:
        if dp > world:
            break
        spp = scaling["spp"] * dp if weak else scaling["spp"]
        st, dt = chunk_seconds(scaling, spp, dp, 2)
        rate = rays(st) / dt / 1e6
        base = rate if base is None else base
        rows.append(dict(mode="weak-scaling" if weak else "scaling",
                         devices=dp, mrays_per_s=rate,
                         efficiency=rate / (base * dp), config="scaling",
                         **label))

    mesh = make_mesh(n_sp=world)
    x = torch.ones((PSUM_ROWS, 3), dtype=torch.float32, device=device)

    def psums(reps: int):
        def run():
            y = x
            for i in range(reps):
                y = mesh.sum_sp(y * (1.0 + 1e-9 * i))
        return run

    ts = {reps: timed(psums(reps), 1) for reps in PSUM_REPS}
    lo, hi = PSUM_REPS
    rows.append(dict(mode="psum-cost", mesh=f"(sp={world},dp=1)",
                     array=f"({PSUM_ROWS},3) f32/device",
                     ms_per_psum=(ts[hi] - ts[lo]) / (hi - lo) * 1e3,
                     config="shard-overhead", **label))
    for dp in SCALING_DPS:
        if dp > world:
            break
        _st, dt = chunk_seconds(tiny, tiny["spp"], dp, 4)
        rows.append(dict(mode="tiny-workload-overhead", devices=dp,
                         ms_per_chunk=dt * 1e3, config="shard-overhead",
                         **label))
    return rows


def bench_scaling(weak: bool, cpu_mesh: int) -> list:
    """The scaling and shard-overhead rows from a spawned world: one rank
    a card (NCCL), or `cpu_mesh` gloo ranks on the CPU."""
    import torch

    from raytracing_gpu_tpu_torch.parallel import dryrun

    if cpu_mesh:
        n, device = cpu_mesh, "cpu"
    else:
        from raytracing_gpu_tpu_torch.ops import build

        build.load()   # once, before the ranks load it
        n, device = torch.cuda.device_count(), "cuda"
    return dryrun.spawn(n, "bench_all_torch:scaling_rank", {"weak": weak},
                        device=device, deadline=1800.0)[0]


def parse_configs(text: str) -> list:
    """`--configs` as `bench_all.py` reads it: a comma-separated subset of
    1-5, where 5 brings 5-rr along."""
    run = []
    for c in text.split(","):
        if c and c not in ("1", "2", "3", "4", "5"):
            raise ValueError(f"config {c!r}: use 1, 2, 3, 4 or 5")
        if c:
            run += ["5", "5-rr"] if c == "5" else [c]
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp-scale", type=int, default=1,
                    help="divide the declared spp by this (rays/s is "
                         "intensive)")
    ap.add_argument("--earth-grad", action="store_true",
                    help="also run the earth atlas-gradient row")
    ap.add_argument("--mesh-grad", action="store_true",
                    help="also run the backpack gradient row")
    ap.add_argument("--configs", default="1,2,3,4,5",
                    help="comma-separated subset of configs to run")
    ap.add_argument("--scaling", action="store_true",
                    help="also run the dp = 1, 2, 4, 8 scaling rows and the "
                         "shard-overhead rows, on one rank a card")
    ap.add_argument("--weak", action="store_true",
                    help="the scaling rows keep each rank's work constant "
                         "(spp scales with dp)")
    ap.add_argument("--cpu-mesh", type=int, default=0, metavar="N",
                    help="run only the scaling and shard-overhead rows, on N "
                         "gloo ranks of the CPU (the plain versions)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if args.spp_scale < 1:
        ap.error("--spp-scale must be at least 1")
    if args.cpu_mesh < 0:
        ap.error("--cpu-mesh must be at least 1")
    if args.cpu_mesh and (args.earth_grad or args.mesh_grad):
        ap.error("--cpu-mesh runs the scaling rows alone")
    try:
        run = [] if args.cpu_mesh else parse_configs(args.configs)
    except ValueError as e:
        ap.error(str(e))

    import torch

    sys.path.insert(0, ROOT)
    import bench_torch

    if args.cpu_mesh:
        card = dict(device="cpu", power_limit=None)
    elif not torch.cuda.is_available():
        raise SystemExit("bench_all_torch: torch.cuda.is_available() is "
                         "False; this benchmark needs a CUDA device")
    else:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        card = dict(device=torch.cuda.get_device_name(0),
                    power_limit=bench_torch.power_limit())
    results, failed = [], []

    def record(tag, thunk):
        # one failed workload must not lose the others' numbers
        try:
            rows = thunk()
        except Exception as e:  # noqa: BLE001 - printed as an error row
            rows = dict(config=tag, error=f"{type(e).__name__}: {e}"[:500])
            failed.append(tag)
        for row in rows if isinstance(rows, list) else [rows]:
            row.setdefault("config", tag)
            row.update(card)
            results.append(row)
            print(json.dumps(row), flush=True)

    for tag in run:
        if tag == "3":
            record(3, lambda: bench_fwd_bwd(args.spp_scale, dev))
        else:
            record(tag if tag == "5-rr" else int(tag),
                   lambda tag=tag: bench_forward(tag, args.spp_scale, dev))
    if args.earth_grad:
        record("earth-grad", lambda: bench_grad("earth", dev))
    if args.mesh_grad:
        record("mesh-grad", lambda: bench_grad("mesh", dev))
    if args.scaling or args.cpu_mesh:
        record("scaling", lambda: bench_scaling(args.weak, args.cpu_mesh))

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(dict(spp_scale=args.spp_scale, **card,
                           results=results), f, indent=1)
    if failed:
        print(f"bench_all_torch: {len(failed)} workload(s) failed: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
