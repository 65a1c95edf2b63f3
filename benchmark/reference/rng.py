"""The counter-based random stream, seeds and chunk bases.

A lane's stream is a PCG hash of its index within its wave mixed with the
wave's int32 seed; each draw site hashes the stream once more with a salt.
The uint32 arithmetic runs in int64 and is masked after every multiply
and add.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
SEED_MIX = 0x85EBCA6B
SALT_MUL = 0x9E3779B9
DRAW_MUL = 0x68E31DA4
CAM_DRAW = (0x7F4A7C15 * DRAW_MUL) & M32
WAVE_MULTIPLIERS = (7919, 104729)


def int32(x: int) -> int:
    """`x` wrapped to int32 two's complement."""
    return (int(x) + 2**31) % 2**32 - 2**31


def wave_seed(base: int, s: int, bid: int) -> int:
    """The int32 seed of sample `s`, wave `bid` of a chunk with base seed
    `base`: base + s * 7919 + bid * 104729, wrapped."""
    return int32(int(base) + s * WAVE_MULTIPLIERS[0]
                 + bid * WAVE_MULTIPLIERS[1])


def seed_mix(seed: int) -> int:
    """uint32(seed) * 0x85EBCA6B mod 2**32: what a wave's lanes XOR in."""
    return ((int(seed) & M32) * SEED_MIX) & M32


def chunk_bases(seed: int, chunks: int) -> list:
    """The base seeds of a render's chunks: one draw in [0, 2**31 - 1)
    each from a CPU `torch.Generator` seeded with the render's seed."""
    gen = torch.Generator().manual_seed(int(seed))
    return [int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                              dtype=torch.int64)) for _ in range(chunks)]


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG output permutation of uint32 values held in int64."""
    x = (x * 747796405 + 2891336453) & M32
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & M32
    return (x >> 22) ^ x


def lane_base(lane: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """A lane's stream: pcg(lane ^ mix), `mix` its wave's `seed_mix`."""
    return pcg_hash(lane ^ mix)


def uniform(base: torch.Tensor, salt: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """U[0, 1) in `dtype` at draw site `salt`: the top 24 bits of the
    hash times 2**-24."""
    bits = pcg_hash((base + ((salt * SALT_MUL) & M32)) & M32)
    return (bits >> 8).to(dtype) * (1.0 / 16777216.0)


def bounce_draw(base: torch.Tensor, b: int) -> torch.Tensor:
    """Bounce b's draw window: base + uint32(32 b) * 0x68E31DA4."""
    return (base + (((b * 32) * DRAW_MUL) & M32)) & M32


def camera_draw(base: torch.Tensor) -> torch.Tensor:
    """The camera's draw window."""
    return (base + CAM_DRAW) & M32
