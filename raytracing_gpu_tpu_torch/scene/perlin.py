"""Perlin noise: hash-gradient noise and turbulence on component tensors.

Counterpart of `raytracing_gpu_tpu/scene/perlin.py` and of the megakernel's
`_hash3`/`_grad_dot`/`_noise3`/`_turb3` (`ops/pallas_trace.py:732-779`),
which compute the same function.  Each lattice corner (i, j, k) is hashed by
the PCG permutation of the kernel's RNG (`ops.cuda_trace.pcg_hash`), and
the low 4 bits of the hash pick one of Ken Perlin's 12 edge gradients; the
corners blend with the cubic Hermite weights of reference
`perlin.h:92-94`, and `turb3` is the fBm sum of `perlin::turb`.

The uint32 arithmetic runs in int64 with a mask after every multiply and
add, as `pcg_hash` does.  The kernel's version is `noise3`/`turb3` in
`ops/csrc/megakernel.cuh`.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
# |noise| reaches ~1.01 with the 12 edge gradients; dividing by 1.15 keeps
# 0.5 * (1 + noise) inside [0, 1] (scene/perlin.py _NORM)
NORM = float(np.float32(1.0 / 1.15))


def _mul32(x: torch.Tensor, a: int) -> torch.Tensor:
    """x * a mod 2**32 for uint32 values x and a held in int64, in two
    halves of a so that no product reaches 2**63."""
    hi = ((x * (a >> 16)) & 0xFFFF) << 16
    return (hi + x * (a & 0xFFFF)) & _M32


def hash3(i: torch.Tensor, j: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Lattice-corner hash of int64 coordinates (int32 values) -> uint32
    values in int64: the coordinates read as uint32, mixed, then PCG."""
    from ..ops.cuda_trace import pcg_hash  # cuda_trace imports this module

    x = (_mul32(i & _M32, 0x8DA6B343) ^ _mul32(j & _M32, 0xD8163841)
         ^ _mul32(k & _M32, 0xCB1AB31F))
    return pcg_hash(x)


def grad_dot(h: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
    """dot(gradient(h), (x, y, z)) for the 12 edge gradients, branch-free."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    u = torch.where((h & 1) == 0, u, -u)
    v = torch.where((h & 2) == 0, v, -v)
    return u + v


def noise3(px: torch.Tensor, py: torch.Tensor,
           pz: torch.Tensor) -> torch.Tensor:
    """Gradient noise at float32 points (px, py, pz), in (-1, 1)."""
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    u, v, w = px - fx, py - fy, pz - fz
    # float -> int32 truncates toward zero, as astype(int32); floors of
    # int32-sized values are exact
    i = fx.to(torch.int32).to(torch.int64)
    j = fy.to(torch.int32).to(torch.int64)
    k = fz.to(torch.int32).to(torch.int64)
    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)
    accum = torch.zeros_like(u)
    for di in (0, 1):
        wi = uu if di else (1.0 - uu)
        for dj in (0, 1):
            wj = vv if dj else (1.0 - vv)
            for dk in (0, 1):
                wk = ww if dk else (1.0 - ww)
                g = grad_dot(hash3(i + di, j + dj, k + dk),
                             u - di, v - dj, w - dk)
                accum = accum + wi * wj * wk * g
    return accum * NORM


def turb3(px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor,
          depth: int = 7) -> torch.Tensor:
    """fBm turbulence: |sum of 0.5**o * noise3(2**o * p)| over `depth`
    octaves (reference `perlin::turb`, `perlin.h:114-126`)."""
    accum = torch.zeros_like(px)
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * noise3(px, py, pz)
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return accum.abs()
