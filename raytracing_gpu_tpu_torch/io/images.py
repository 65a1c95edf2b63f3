"""Image decode for image textures.

Counterpart of `raytracing_gpu_tpu/io/images.py` (the reference's
`imread`/`make_image`, `texture.h:166-203`).  PIL is imported only when a
file is decoded, so the package needs it only for image files: an array
handed to `SceneBuilder.image` needs no decoder.
"""

from __future__ import annotations

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Decode an image file -> (H, W, 3) float32 in [0, 1]."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.float32)
    return arr / 255.0
