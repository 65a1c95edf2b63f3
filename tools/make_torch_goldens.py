"""Write the pinned JAX goldens that the PyTorch port is held to.

Runs the JAX package on the CPU (the Pallas megakernel in interpret mode)
and writes `tests/data/torch_port/cornell_32.npz`: one chunk of the Cornell
box at 32x32, 2 spp, depth 3, as `compile_renderer(engine="pallas")`
returns it ((npix_pad, 3) float32 radiance sums), with the int32 base seed
and the settings that produced it.  The port's CPU tests hold its plain
version to this file, and `chip_smoke.py` holds the CUDA kernel to it, so
the card's output is tied to the JAX reference without JAX on that machine.

    python tools/make_torch_goldens.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port", "cornell_32.npz")
KEY_SEED = 2024


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from raytracing_gpu_tpu.core.config import RenderSettings
    from raytracing_gpu_tpu.engine.render import compile_renderer
    from raytracing_gpu_tpu.models import scenes
    from raytracing_gpu_tpu.ops import pallas_trace

    sd = scenes.get("cornell_box")
    st = RenderSettings(image_width=32, aspect_ratio=sd.aspect,
                        spp_per_chunk=2, num_chunks=1, max_depth=3,
                        ray_batch=65536)
    key = jax.random.PRNGKey(KEY_SEED)
    base = int(pallas_trace.chunk_seed(key))
    chunk = compile_renderer(sd.scene, sd.camera, st, engine="pallas")
    sums = np.asarray(chunk(key), np.float32)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(
        OUT, base=np.int32(base), key_seed=np.int32(KEY_SEED), sums=sums,
        image_width=st.image_width, image_height=st.image_height,
        spp_per_chunk=st.spp_per_chunk, max_depth=st.max_depth,
        ray_batch=st.ray_batch, t_min=np.float32(st.t_min))
    print(f"wrote {OUT}: base {base}, sums {sums.shape}, "
          f"mean {sums.mean(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
