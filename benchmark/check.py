"""Whether what the timed path produced is right: the port's outputs
against the plain reference's, number by number, each under its limit.

A render cell compares, for requests of the window drawn from the seed,
the finished image at the pixels kept from every request (`RenderLoad`):
the share of their 8-bit values that differ (`uint8_mismatch`) and the
mean absolute gap of the [0, 1) image (`mean_abs_gap`).  The reference
traces those pixels' own samples (every chunk's base, every sample's
wave seed), so the comparison covers the chunks' sums, their
accumulation over the chunks and the finishing.

A training cell compares the first steps that set-up drove through the
window's own call (`TrainLoad.check_steps`): the worst relative gap of
the steps' losses (`loss_gap`), the first step's sums (`sums_gap`, the
summed absolute gap over the summed reference), and, leaf by leaf, the
norm of the first gradient (`grad_gap`) and of the parameters' change
over the steps (`change_gap`).  A leaf is one texture's row of a
parameter (or the whole atlas); its gap is |norm(port) - norm(ref)| over
the larger of the reference's norm of the leaf and the median leaf's.
Leaves whose reference gradient is under a thousandth of the median of
the nonzero ones are left out: they move by round-off alone.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from .reference import drive
from .reference import scene as ref_scene

LEAF_FLOOR = 1e-3


def reference_parts(config: dict, height: int, width: int,
                    ray_batch: int) -> tuple:
    """(scene, camera, geometry) of the reference for a configuration."""
    return (ref_scene.build_scene(config["scene"]),
            ref_scene.build_camera(config["camera"], height, width),
            drive.Geometry.of(height, width, ray_batch))


def pick(n: int, k: int, seed: int) -> list:
    """k of n indices drawn from the seed, the last one always among
    them."""
    rng = np.random.default_rng([int(seed), 1])
    k = min(k, n)
    rest = rng.choice(n - 1, size=k - 1, replace=False) if k > 1 else []
    return sorted({int(i) for i in rest} | {n - 1})


def render_numbers(got: list, want: list) -> dict:
    """The render comparison of (image, uint8) pairs, port's and
    reference's, pooled over the checked requests."""
    img_p = np.concatenate([g[0] for g in got])
    img_r = np.concatenate([w[0] for w in want])
    u8_p = np.concatenate([g[1] for g in got])
    u8_r = np.concatenate([w[1] for w in want])
    return {"uint8_mismatch": float(np.mean(u8_p != u8_r)),
            "mean_abs_gap": float(np.mean(np.abs(img_p - img_r)))}


def render_reference(config: dict, pix: np.ndarray, seeds: list, device,
                     dtype=torch.float32, counts=None) -> list:
    """The reference's (image, uint8) at pixels `pix` of the renders with
    seeds `seeds` at the configuration's settings."""
    st = config["settings"]
    h = int(st["image_width"] / st["aspect_ratio"])
    sc, cam, geom = reference_parts(config, h, st["image_width"],
                                    st["ray_batch"])
    p = drive.np_pixels(pix, device)
    return [drive.render_pixels(sc, cam, geom, s, st["num_chunks"],
                                st["spp_per_chunk"], p, st["max_depth"],
                                st["t_min"], dtype, counts) for s in seeds]


def leaves(params: dict) -> dict:
    """A parameter dict's leaves: each texture's row of tex_c1 and tex_c2,
    and the atlas whole, as float64 host vectors."""
    out = {}
    for k in ("tex_c1", "tex_c2"):
        for i, row in enumerate(params[k].detach().double().cpu()):
            out[f"{k}[{i}]"] = row
    out["atlas_data"] = params["atlas_data"].detach().double().cpu() \
        .reshape(-1)
    return out


def counted(ref_grad: dict) -> list:
    """The leaves compared: a reference gradient at least a thousandth of
    the median of the nonzero ones."""
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in
             ref_grad.items()}
    nonzero = [n for n in norms.values() if n > 0]
    if not nonzero:
        return []
    floor = LEAF_FLOOR * statistics.median(nonzero)
    return sorted(k for k, n in norms.items() if n >= floor)


def leaf_gap(got: dict, want: dict, names: list) -> float:
    """The worst leaf's |norm(got) - norm(want)| over the larger of
    norm(want) and the median leaf's norm."""
    norms = {k: float(torch.linalg.vector_norm(want[k])) for k in names}
    med = statistics.median(norms.values())
    worst = 0.0
    for k in names:
        gap = abs(float(torch.linalg.vector_norm(got[k])) - norms[k])
        worst = max(worst, gap / max(norms[k], med))
    return worst


def as_params(albedo: torch.Tensor, like: dict) -> dict:
    """The reference's albedos as a parameter dict shaped as `like`: the
    albedo rows are tex_c1; tex_c2 and the atlas, which the solid
    textures' shade does not read, are zero."""
    return {"tex_c1": albedo.detach().float().cpu(),
            "tex_c2": torch.zeros_like(like["tex_c2"].detach().cpu()),
            "atlas_data": torch.zeros_like(like["atlas_data"].detach().cpu())}


def train_reference(config: dict, traffic: dict, factors: dict,
                    target: torch.Tensor, bases: list,
                    dtype=torch.float32) -> dict:
    """The reference's first steps from the perturbed albedos."""
    st = config["settings"]
    h = int(st["image_width"] / st["aspect_ratio"])
    sc, cam, geom = reference_parts(config, h, st["image_width"],
                                    traffic["ray_batch"])
    f = factors["tex_c1"]
    if tuple(f.shape) != tuple(sc.albedo.shape):
        raise ValueError(f"tex_c1 {tuple(f.shape)} against the "
                         f"configuration's {sc.albedo.shape} albedos")
    albedo0 = torch.as_tensor(sc.albedo) * f
    out = drive.train_steps(sc, cam, geom, albedo0, target, bases,
                            traffic["spp"], traffic["lr"], st["max_depth"],
                            st["t_min"], dtype)
    out["albedo0"] = albedo0
    out["npix"] = geom.npix
    return out


def train_numbers(kept: dict, p0: dict, ref: dict) -> dict:
    """The training comparison of the port's kept steps (`TrainLoad.kept`)
    from its start `p0` against the reference's (`train_reference`)."""
    losses = [abs(a - b) / abs(b) if b else math.inf
              for a, b in zip(kept["losses"], ref["losses"])]
    n = ref["npix"]
    s_p = kept["sums"][:n].double().cpu()
    s_r = ref["sums"][:n].double().cpu()
    sums_gap = float((s_p - s_r).abs().sum() / s_r.abs().sum())
    g_ref = leaves(as_params(ref["grad"], p0))
    names = counted(g_ref)
    d_prog = {k: v - p for (k, v), p in zip(leaves(kept["params"]).items(),
                                            leaves(p0).values())}
    ref_p3 = as_params(ref["albedo"], p0)
    ref_p0 = as_params(ref["albedo0"], p0)
    d_ref = {k: v - p for (k, v), p in zip(leaves(ref_p3).items(),
                                           leaves(ref_p0).values())}
    return {"loss_gap": max(losses), "sums_gap": sums_gap,
            "grad_gap": leaf_gap(leaves(kept["grad"]), g_ref, names),
            "change_gap": leaf_gap(d_prog, d_ref, names)}


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number is finite and at most its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
