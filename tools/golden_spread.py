"""How far the port's forward chunk sits from the JAX package's, over seeds.

For each dense scene of `make_torch_goldens.SCENES`, renders the golden's
chunk (width 32 at the scene's aspect, 2 spp, depth 3) for several PRNG
keys through the JAX package on the CPU (the Pallas megakernel in interpret
mode, as the goldens are made) and through the port's plain version on the
CPU, and prints per key the share of pixels within atol 1e-3 * max and the
largest relative difference of a channel mean (`golden_cmp`'s two
readings in `chip_smoke.py`).  A path that diverges after a bounce on an ulp
of sin/cos/log moves a mean of these small chunks on its own, so the limit
on the mean is set from this spread, not from one golden.

    python tools/golden_spread.py [--keys N] [scene ...]

Prints one JSON line per (scene, key) and a last JSON line with the worst
reading per scene.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from make_torch_goldens import KEY_SEED, SCENES  # noqa: E402


def readings(got, want) -> dict:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    within = float((err <= 1e-3 * np.abs(want).max()).all(-1).mean())
    mean_rel = float((np.abs(got.mean(0) - want.mean(0))
                      / np.maximum(np.abs(want.mean(0)), 1e-30)).max())
    return dict(frac_within=within, mean_rel_err=mean_rel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=8)
    ap.add_argument("scenes", nargs="*", default=list(SCENES))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from raytracing_gpu_tpu.core.config import RenderSettings as JaxSettings
    from raytracing_gpu_tpu.engine.render import compile_renderer as jax_chunk
    from raytracing_gpu_tpu.models import scenes as jscenes
    from raytracing_gpu_tpu.ops import pallas_trace
    from raytracing_gpu_tpu_torch import RenderSettings, compile_renderer
    from raytracing_gpu_tpu_torch.models import scenes as tscenes

    torch.set_num_threads(1)
    worst = {}
    for name in args.scenes:
        jsd, tsd = jscenes.get(name), tscenes.get(name)
        shape = dict(image_width=32, aspect_ratio=jsd.aspect, spp_per_chunk=2,
                     num_chunks=1, max_depth=3, ray_batch=65536)
        jchunk = jax_chunk(jsd.scene, jsd.camera, JaxSettings(**shape),
                           engine="pallas")
        tchunk = compile_renderer(tsd.scene, tsd.camera,
                                  RenderSettings(**shape), device="cpu")
        for i in range(args.keys):
            key = jax.random.PRNGKey(KEY_SEED + i)
            base = int(pallas_trace.chunk_seed(key))
            res = dict(scene=name, key_seed=KEY_SEED + i, base=base,
                       **readings(tchunk(base).numpy(), jchunk(key)))
            print(json.dumps(res), flush=True)
            w = worst.setdefault(name, dict(frac_within=1.0,
                                            mean_rel_err=0.0))
            w["frac_within"] = min(w["frac_within"], res["frac_within"])
            w["mean_rel_err"] = max(w["mean_rel_err"], res["mean_rel_err"])
    print(json.dumps({"keys": args.keys, "worst": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
