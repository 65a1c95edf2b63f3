"""The (sp, dp) mesh of ranks (counterpart of
`raytracing_gpu_tpu/parallel/mesh.py`).

- axis "sp", sample parallelism: ranks render disjoint sample subsets of
  every pixel and sum their partial sums over the sp group (`sum_sp`), the
  reference's frame-buffer ensemble (`render.h:152-162`) as a collective;
- axis "dp", pixel parallelism: ranks own disjoint pixel spans, which
  `gather_dp` joins into the whole frame on every rank.

The ranks are laid out as the JAX package lays out its devices,
`reshape(n_sp, n_dp)` row-major: the r-th rank of the mesh's list is
(sp = r // n_dp, dp = r % n_dp).  The scene is replicated: every rank bakes
its own.  A world of one rank, or no process group at all, is a 1x1 mesh
whose collectives are the identity.  A collective over a gloo group (ranks
that share a card, `distributed.choose_backend`) stages a CUDA tensor
through the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

SP_AXIS = "sp"
DP_AXIS = "dp"


def layout(ranks: Sequence[int], n_sp: int = 1,
           n_dp: Optional[int] = None) -> np.ndarray:
    """The (n_sp, n_dp) grid of `ranks`, row-major, as `make_mesh` lays out
    the JAX package's devices (`mesh.py:29-38`)."""
    ranks = list(ranks)
    if len(set(ranks)) != len(ranks):
        raise ValueError(f"ranks {ranks} repeat a rank")
    if n_dp is None:
        if len(ranks) % n_sp:
            raise ValueError(f"{len(ranks)} devices not divisible by "
                             f"n_sp={n_sp}")
        n_dp = len(ranks) // n_sp
    if n_sp < 1 or n_dp < 1 or n_sp * n_dp > len(ranks):
        raise ValueError(f"an ({n_sp}, {n_dp}) mesh needs {n_sp * n_dp} "
                         f"ranks; there are {len(ranks)}")
    return np.array(ranks[:n_sp * n_dp], dtype=np.int64).reshape(n_sp, n_dp)


class Mesh:
    """An (sp, dp) grid of ranks and this rank's place in it.

    `shape` maps the axis names to their sizes, `ranks` is the grid, `sp`
    and `dp` are this rank's coordinates (None, with `member` False, on a
    rank outside the grid, which takes no part in its work or its
    collectives).  The collectives take this rank's tensor and return the
    result on every rank of the group."""

    def __init__(self, grid: np.ndarray, rank: int,
                 groups: Optional[dict] = None):
        self.ranks = grid
        self.shape = {SP_AXIS: int(grid.shape[0]), DP_AXIS: int(grid.shape[1])}
        where = np.argwhere(grid == rank)
        self.member = len(where) > 0
        self.sp, self.dp = ((int(where[0][0]), int(where[0][1]))
                            if self.member else (None, None))
        self._groups = groups or {}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def __repr__(self) -> str:
        return (f"Mesh(sp={self.shape[SP_AXIS]}, dp={self.shape[DP_AXIS]}, "
                f"this rank at sp={self.sp}, dp={self.dp})")

    def sum_sp(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over this rank's sp group (the sample reduce)."""
        return self._all_reduce(x, SP_AXIS, self.shape[SP_AXIS])

    def sum_all(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over every rank of the mesh."""
        return self._all_reduce(x, "mesh", self.size)

    def gather_dp(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's dp group's spans `x`, concatenated along dim 0 in dp
        order: after `sum_sp` every sp row holds the same spans, so every
        rank gets the whole frame."""
        n = self.shape[DP_AXIS]
        if n == 1:
            return x
        group = self._group(DP_AXIS)
        y = _staged(x, group)
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y.contiguous(), group=group)
        # a group orders its ranks ascending; put the spans in dp order
        row = self.ranks[self.sp]
        by_dp = [None] * n
        for k, i in enumerate(np.argsort(row, kind="stable")):
            by_dp[int(i)] = parts[k]
        return torch.cat(by_dp).to(x.device)

    def _group(self, name: str):
        if not self.member:
            raise ValueError("this rank is not in the mesh")
        return self._groups[name]

    def _all_reduce(self, x: torch.Tensor, name: str, n: int) -> torch.Tensor:
        if n == 1:
            return x
        group = self._group(name)
        y = _staged(x, group).clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y.to(x.device)


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """`x` on the host for a gloo group, else as it is."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x


def make_mesh(n_sp: int = 1, n_dp: Optional[int] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """An (sp, dp) mesh over `ranks` (default: every rank of the world).

    Every rank of the world must call it, with the same arguments: it
    creates the groups of every sp column, every dp row and the whole grid
    (`torch.distributed.new_group`), in the same order on every rank.
    Without a process group the world is this one process, and only a 1x1
    mesh fits it."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if any(not 0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} outside a world of {world}")
    grid = layout(ranks, n_sp, n_dp)
    if world == 1:
        return Mesh(grid, rank)
    groups = {}
    for col in grid.T:
        g = dist.new_group(sorted(col.tolist()))
        if rank in col:
            groups[SP_AXIS] = g
    for row in grid:
        g = dist.new_group(sorted(row.tolist()))
        if rank in row:
            groups[DP_AXIS] = g
    g = dist.new_group(sorted(grid.ravel().tolist()))
    if rank in grid:
        groups["mesh"] = g
    return Mesh(grid, rank, groups)


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1)
