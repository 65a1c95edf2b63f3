"""Stackless BVH traversal of a whole ray batch in torch ops.

Counterpart of `raytracing_gpu_tpu/accel/traverse.py`: every ray of the
batch holds one node cursor, and each step advances all of them by one
threaded link of a `FlatBVH` (`accel/bvh.py`): the hit link when the
node's box is hit closer than the ray's best t, the miss link otherwise.
A leaf's K primitives are tested together and an argmin over them keeps
the first least t.  The loop ends when every cursor is -1; it tests that
on the host once a step.

This is the XLA engine's walk (`engine/intersect.py` `closest_hit`), and so
an oracle for the kernels' own walks (`ops/cuda_trace.py`, `ops/csrc/`),
with which it shares no code: it follows the JAX package's arithmetic and
preorder links, where the kernels walk leaf-contiguous rows.  Outputs are
detached, as the JAX package stops their gradient.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core import vec
from .bvh import FlatBVH

BIG = 1e30
_EPS_DIV = 1e-12
_TRI_EPS = 1e-7


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1 / d with |d| floored at 1e-12, keeping its sign."""
    tiny = torch.where(d >= 0, _EPS_DIV, -_EPS_DIV)
    return 1.0 / torch.where(d.abs() < _EPS_DIV, tiny, d)


def _traverse(bvh: FlatBVH, leaf_test: Callable, o: torch.Tensor,
              d: torch.Tensor, t_min: float, t_max: float) -> tuple:
    """The threaded-link walk (`traverse._traverse`).

    bvh: a FlatBVH of tensors on the rays' device, links as int64.
    leaf_test(prim_ids (N, K), t_best (N,)) -> t (N, K), BIG on a miss.
    Returns (t_best (N,), idx (N,) int64): BIG and index 0 on a miss."""
    n = o.shape[0]
    inv = _safe_inv(d)
    node = torch.zeros(n, dtype=torch.int64, device=o.device)
    t_best = torch.full((n,), min(BIG, t_max), dtype=torch.float32,
                        device=o.device)
    i_best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    while bool((node >= 0).any()):
        nid = node.clamp(min=0)
        t0 = (bvh.node_min[nid] - o) * inv
        t1 = (bvh.node_max[nid] - o) * inv
        tn = torch.minimum(t0, t1).amax(dim=-1)
        tf = torch.maximum(t0, t1).amin(dim=-1)
        live = node >= 0
        hit_box = live & (tf >= torch.clamp(tn, min=t_min)) & (tn <= t_best)

        prim_ids = bvh.leaf_prims[nid]                      # (N, K)
        valid = hit_box[:, None] & (prim_ids >= 0)
        ts = torch.where(valid, leaf_test(prim_ids.clamp(min=0), t_best),
                         BIG)
        k_best = torch.argmin(ts, dim=1, keepdim=True)      # the first least
        t_k = torch.gather(ts, 1, k_best)[:, 0]
        better = t_k < t_best
        t_best = torch.where(better, t_k, t_best)
        i_best = torch.where(better, torch.gather(prim_ids, 1, k_best)[:, 0],
                             i_best)
        nxt = torch.where(hit_box, bvh.hit_link[nid], bvh.miss_link[nid])
        node = torch.where(live, nxt, -1)
    t_best = torch.where(i_best >= 0, t_best, BIG)
    return t_best.detach(), i_best.clamp(min=0)


def traverse_triangles(tris, bvh: FlatBVH, o: torch.Tensor, d: torch.Tensor,
                       t_min: float, t_max: float = BIG) -> tuple:
    """(t, idx) of the closest triangle under the triangle BVH
    (`traverse.traverse_triangles`): Moller-Trumbore on the leaf's K
    triangles (reference `triangle.h:120-160`), determinants below 1e-7
    refused.  `tris` holds the triangle table's v0, e1, e2 as tensors."""
    o, d = o.detach(), d.detach()

    def leaf_test(ids, t_best):
        v0, e1, e2 = tris.v0[ids], tris.e1[ids], tris.e2[ids]  # (N, K, 3)
        dd = d[:, None, :]
        h = vec.cross(dd, e2)
        a = vec.dot(e1, h)
        f = 1.0 / torch.where(a.abs() < _TRI_EPS, _TRI_EPS, a)
        s = o[:, None, :] - v0
        u = f * vec.dot(s, h)
        q = vec.cross(s, e1)
        v = f * vec.dot(dd, q)
        t = f * vec.dot(e2, q)
        ok = ((a.abs() > _TRI_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
              & (u + v <= 1.0) & (t >= max(t_min, _TRI_EPS))
              & (t <= t_best[:, None]))
        return torch.where(ok, t, BIG)

    return _traverse(bvh, leaf_test, o, d, t_min, t_max)


def traverse_spheres(spheres, bvh: FlatBVH, o: torch.Tensor, d: torch.Tensor,
                     tm: torch.Tensor, t_min: float,
                     t_max: float = BIG) -> tuple:
    """(t, idx) of the closest non-medium sphere under the sphere BVH
    (`traverse.traverse_spheres`): the quadratic with the near root, else
    the far one (reference `sphere.h:35-73`, corrected as the JAX package
    does), the center moved to each ray's time.  `spheres` holds the
    sphere table's columns as tensors."""
    o, d = o.detach(), d.detach()
    a = vec.dot(d, d)[:, None]
    inv_a = 1.0 / torch.clamp(a, min=_EPS_DIV)

    def leaf_test(ids, t_best):
        t0, t1 = spheres.time0[ids], spheres.time1[ids]
        denom = torch.where((t1 - t0).abs() < 1e-12, 1.0, t1 - t0)
        frac = (tm[:, None] - t0) / denom
        c0 = spheres.center0[ids]
        center = c0 + frac[..., None] * (spheres.center1[ids] - c0)
        oc = o[:, None, :] - center
        half_b = vec.dot(oc, d[:, None, :])
        r = spheres.radius[ids]
        c = vec.dot(oc, oc) - r * r
        disc = half_b * half_b - a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        near = (-half_b - sq) * inv_a
        far = (-half_b + sq) * inv_a
        has = disc > 0
        ok_near = has & (near >= t_min) & (near <= t_best[:, None])
        ok_far = has & (far >= t_min) & (far <= t_best[:, None])
        return torch.where(ok_near, near, torch.where(ok_far, far, BIG))

    return _traverse(bvh, leaf_test, o, d, t_min, t_max)
