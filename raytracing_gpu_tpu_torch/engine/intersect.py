"""The structure-of-arrays hit record.

Counterpart of `raytracing_gpu_tpu/engine/intersect.py`'s `HitRecord`
(reference `hit_record`, `hittable.h:8-23`).  The closest hit itself is the
hit kernel's (`ops.cuda_trace.Tracer.hit`); the JAX package's XLA
`closest_hit` is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class HitRecord(NamedTuple):
    hit: torch.Tensor         # (N,) bool
    t: torch.Tensor           # (N,)
    p: torch.Tensor           # (N, 3)
    normal: torch.Tensor      # (N, 3) faced against the ray
    front_face: torch.Tensor  # (N,) bool
    u: torch.Tensor           # (N,)
    v: torch.Tensor           # (N,)
    mat_id: torch.Tensor      # (N,) int32
