"""What the comparison asks of the reference: sampled pixels of a finished
render, a target image, and the first steps of an inverse-rendering run.

A render is chunks of samples of every pixel in waves of `wave` pixels;
sample s of wave bid of a chunk with base seed `base` is seeded
`rng.wave_seed(base, s, bid)`, and a pixel is lane `pix % wave` of wave
`pix // wave`.  Each chunk's sums are added sample after sample from 0,
and the chunks' sums chunk after chunk, in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import film, paths, rng, train
from .scene import Camera, Scene


@dataclass(frozen=True)
class Geometry:
    """An image of height x width pixels in waves of `wave` pixels: the
    wave is the requested batch, at most the pixels rounded up to 8, and
    the pixel rows are padded to whole waves (a row past the image traces
    its last pixel)."""

    height: int
    width: int
    wave: int

    @classmethod
    def of(cls, height: int, width: int, ray_batch: int) -> "Geometry":
        npix = height * width
        return cls(height, width, min(int(ray_batch), -(-npix // 8) * 8))

    @property
    def npix(self) -> int:
        return self.height * self.width

    @property
    def waves(self) -> int:
        return -(-self.npix // self.wave)

    @property
    def rows(self) -> int:
        return self.waves * self.wave


def _lanes(geom: Geometry, bases: list, spp: int, pix: torch.Tensor):
    """(pixel, stream) of every (chunk, sample, pixel) lane in that order."""
    dev = pix.device
    bid = torch.div(pix, geom.wave, rounding_mode="floor")
    lane = pix - bid * geom.wave
    mix = torch.tensor([[[rng.seed_mix(rng.wave_seed(base, s, w))
                          for w in range(geom.waves)] for s in range(spp)]
                        for base in bases], dtype=torch.int64, device=dev)
    mixes = mix[:, :, bid]                         # (C, S, K)
    base = rng.lane_base(lane.expand_as(mixes), mixes)
    return pix.expand_as(mixes).reshape(-1), base.reshape(-1)


def sample_sums(scene: Scene, cam: Camera, geom: Geometry, bases: list,
                spp: int, pix: torch.Tensor, depth: int, t_min: float,
                dtype: torch.dtype = torch.float32, counts=None
                ) -> torch.Tensor:
    """The (K, 3) sums of pixels `pix` over chunks with base seeds
    `bases` of `spp` samples each."""
    lane_pix, lane_base = _lanes(geom, bases, spp, pix)
    rad = paths.trace(scene, cam, lane_pix, lane_base, depth, t_min,
                      dtype=dtype, counts=counts)
    rad = rad.view(len(bases), spp, pix.numel(), 3)
    total = torch.zeros((pix.numel(), 3), dtype=dtype, device=pix.device)
    for c in range(len(bases)):
        row = torch.zeros_like(total)
        for s in range(spp):
            row = row + rad[c, s]
        total = total + row
    return total


def render_pixels(scene: Scene, cam: Camera, geom: Geometry, seed: int,
                  chunks: int, spp: int, pix: torch.Tensor, depth: int,
                  t_min: float, dtype: torch.dtype = torch.float32,
                  counts=None) -> tuple:
    """(image float64 (K, 3), uint8 (K, 3)) of pixels `pix` of the render
    with seed `seed`: `chunks` chunks of `spp` samples, each chunk's base
    drawn by `rng.chunk_bases`."""
    sums = sample_sums(scene, cam, geom, rng.chunk_bases(seed, chunks), spp,
                       pix, depth, t_min, dtype, counts)
    return film.finalize(sums.float().cpu().numpy(), chunks * spp)


def target_image(scene: Scene, cam: Camera, geom: Geometry, seed: int,
                 spp: int, depth: int, t_min: float, device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The (npix, 3) mean radiance of one chunk of `spp` samples with base
    `rng.chunk_bases(seed, 1)`, in blocks of pixels."""
    base = rng.chunk_bases(seed, 1)
    out = torch.empty((geom.npix, 3), dtype=dtype, device=device)
    step = max(1, (1 << 21) // spp)
    for lo in range(0, geom.npix, step):
        pix = torch.arange(lo, min(geom.npix, lo + step), device=device)
        out[lo:lo + pix.numel()] = sample_sums(
            scene, cam, geom, base, spp, pix, depth, t_min, dtype) / spp
    return out


def _walk_chunk(scene: Scene, cam: Camera, geom: Geometry, base: int,
                spp: int, depth: int, t_min: float, device,
                dtype: torch.dtype) -> torch.Tensor:
    """Record planes (spp * waves, depth, wave) of a training chunk's
    waves in the schedule order (sample-major)."""
    n_w, b = spp * geom.waves, geom.wave
    lane = torch.arange(b, device=device)
    out = torch.empty((n_w, depth, b), dtype=torch.int32, device=device)
    group = max(1, (1 << 21) // b)
    for w0 in range(0, n_w, group):
        ws = range(w0, min(n_w, w0 + group))
        pix = torch.cat([(w % geom.waves) * b + lane for w in ws])
        mix = torch.tensor([rng.seed_mix(rng.wave_seed(base, w // geom.waves,
                                                       w % geom.waves))
                            for w in ws], dtype=torch.int64, device=device)
        base_l = rng.lane_base(lane.repeat(len(ws)),
                               mix.repeat_interleave(b))
        planes = paths.trace(scene, cam, pix, base_l, depth, t_min,
                             record=True, dtype=dtype)
        out[w0:w0 + len(ws)] = planes.view(depth, len(ws), b).transpose(0, 1)
    return out


def _groups(planes: torch.Tensor, lanes: int = 1 << 20):
    """Consecutive waves of record planes (waves, depth, wave), about
    `lanes` lanes a group: (wave indices, planes (depth, lanes))."""
    n_w, depth, b = planes.shape
    g = max(1, lanes // b)
    for w0 in range(0, n_w, g):
        ws = range(w0, min(n_w, w0 + g))
        yield ws, planes[w0:w0 + len(ws)].transpose(0, 1).reshape(depth, -1)


def train_steps(scene: Scene, cam: Camera, geom: Geometry, albedo0,
                target: torch.Tensor, bases: list, spp: int, lr: float,
                depth: int, t_min: float,
                dtype: torch.dtype = torch.float32) -> dict:
    """Steps of inverse rendering from the albedos `albedo0` ((M, 3)):
    each the chunk's sums of `spp` samples with the step's base, the L2
    loss of their mean against `target`, its gradient by the closed-form
    adjoint, and an Adam step of rate `lr`.  Returns the losses, the first
    step's sums (rows, 3) and gradient, and the albedos after the last
    step."""
    device = target.device
    albedo = torch.as_tensor(albedo0, device=device).to(dtype)
    adam = train.Adam({"albedo": albedo}, lr)
    target = target.to(dtype)
    out = {"losses": []}
    for k, base in enumerate(bases):
        planes = _walk_chunk(scene, cam, geom, base, spp, depth, t_min,
                             device, dtype)
        sums = torch.zeros((geom.waves, geom.wave, 3), dtype=dtype,
                           device=device)
        for ws, packed in _groups(planes):
            rad = train.shade(packed, scene, albedo).view(len(ws), -1, 3)
            for j, w in enumerate(ws):
                sums[w % geom.waves] += rad[j]
        sums = sums.view(geom.rows, 3)
        img = sums[:geom.npix] / spp
        loss = train.l2_loss(img, target)
        g = torch.zeros_like(sums)
        g[:geom.npix] = train.loss_cotangent(img, target) / spp
        g = g.view(geom.waves, geom.wave, 3)
        grad = torch.zeros_like(albedo)
        for ws, packed in _groups(planes):
            g_ws = torch.cat([g[w % geom.waves] for w in ws])
            grad += train.albedo_grad(packed, scene, albedo, g_ws)
        out["losses"].append(float(loss))
        if k == 0:
            out["sums"], out["grad"] = sums, grad
        albedo = adam.step({"albedo": albedo}, {"albedo": grad})["albedo"]
        del planes
    out["albedo"] = albedo
    return out


def np_pixels(pix: np.ndarray, device) -> torch.Tensor:
    """Pixel indices as an int64 tensor on `device`."""
    return torch.as_tensor(np.asarray(pix, np.int64), device=device)
