#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port: Mrays/s forward + backward on the
Cornell box, on one CUDA card.

    python3 bench_torch.py [--reps N]

The port of `bench.py`, with its workload: the Cornell box at 512x512,
64 spp as 8 chunks of 8 spp, depth 8, waves of 32,768 rays; every chunk
computes the L2 loss `mean((chunk - target)**2)` against a zero target and
its gradient with respect to {tex_c1, tex_c2, atlas_data}, through
`engine.fused_diff.compile_fused_param_renderer` (the record kernel, then
the shading and its closed-form adjoint in torch).  Losses and gradients
are summed over the chunks, so no chunk's work can be skipped.  "Rays"
count as in `bench.py`: one camera sample is one ray, so
Mrays/s = pixels * spp * reps / seconds / 1e6.

Timing: one warm-up (the kernel build and the first launches), then three
trials of `--reps` complete 64-spp renders each, every trial between
`torch.cuda.synchronize()` points on the host clock; the median trial
counts.  Every chunk of every render draws its own base seed.

Prints one JSON line with `bench.py`'s keys (`metric`, `value`, `unit`,
`vs_baseline`) plus the card's name (`device`) and power limit
(`power_limit`, from nvidia-smi).  `vs_baseline` is null: `bench.py`'s
baseline is a TPU number.  Exits non-zero, with no result line, when no
CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH = 512
SPP_TOTAL = 64
SPP_PER_CHUNK = 8
MAX_DEPTH = 8
RAY_BATCH = 32768
SEED = 1984
METRIC = "Mrays/s/chip fwd+bwd (Cornell box 512^2, 64spp, depth 8)"


def settings():
    from raytracing_gpu_tpu_torch import RenderSettings

    return RenderSettings(image_width=WIDTH, aspect_ratio=1.0,
                          spp_per_chunk=SPP_PER_CHUNK,
                          num_chunks=SPP_TOTAL // SPP_PER_CHUNK,
                          max_depth=MAX_DEPTH, ray_batch=RAY_BATCH)


def power_limit() -> str:
    """The card's power limit as nvidia-smi reports it, e.g. "700.00 W"."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def train_renders(chunk, params: dict, target, bases):
    """`bench.py`'s loop body: for every chunk base, the L2 loss and its
    gradients; returns their sums (loss, {name: gradient})."""
    import torch

    from raytracing_gpu_tpu_torch.engine import diff

    acc_loss = torch.zeros((), device=target.device)
    acc_grads = {k: torch.zeros_like(v) for k, v in params.items()}
    for base in bases:
        loss, grads = diff.value_and_grad(
            params, lambda p, base=base: chunk(p, base), target)
        acc_loss = acc_loss + loss
        acc_grads = {k: acc_grads[k] + grads[k] for k in acc_grads}
    return acc_loss, acc_grads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=1,
                    help="complete 64-spp renders per timed trial")
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps must be at least 1")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch: torch.cuda.is_available() is False; "
                         "this benchmark needs a CUDA device")
    sys.path.insert(0, ROOT)
    from raytracing_gpu_tpu_torch.engine import diff
    from raytracing_gpu_tpu_torch.engine.fused_diff import (
        compile_fused_param_renderer)
    from raytracing_gpu_tpu_torch.models import scenes
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sd = scenes.get("cornell_box")
    st = settings()
    chunk = compile_fused_param_renderer(sd.scene, sd.camera, st, device=dev)
    params = diff.get_params(sd.scene, dev)
    gen = torch.Generator().manual_seed(SEED)
    target = torch.zeros_like(chunk(params, cuda_trace.chunk_seed(gen)))

    def trial() -> float:
        bases = [cuda_trace.chunk_seed(gen)
                 for _ in range(args.reps * st.num_chunks)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = train_renders(chunk, params, target, bases)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not (torch.isfinite(loss) and all(torch.isfinite(g).all()
                                             for g in grads.values())):
            raise AssertionError("non-finite loss or gradient")
        return dt

    trial()  # warm-up
    dt = sorted(trial() for _ in range(3))[1]
    rays = WIDTH * WIDTH * SPP_TOTAL * args.reps
    print(json.dumps({
        "metric": METRIC,
        "value": rays / dt / 1e6,
        "unit": "Mrays/s",
        "vs_baseline": None,
        "device": torch.cuda.get_device_name(0),
        "power_limit": power_limit(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
