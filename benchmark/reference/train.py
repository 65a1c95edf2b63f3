"""An inverse-rendering step: the shade of recorded paths, the L2 image
loss, its closed-form adjoint and Adam.

A path's radiance over its recorded bounces is L = sum_b T_b E_b with
E_b = miss_b * background + hit_b * emit_b and T_{b+1} = T_b F_b,
F_b = cont_b * albedo_b + (1 - cont_b) (`render.h:55-81`).  With the
suffix sum S_b = E_b + F_b S_{b+1}, the loss's gradient reaches the
albedo of the material hit at bounce b as g T_b S_{b+1} cont_b, and a
light's emission (its albedo) as g T_b hit_b.
"""

from __future__ import annotations

import torch

from .paths import CONT_BIT, HIT_BIT, MISS_BIT
from .scene import DIFFUSE_LIGHT, Scene

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def _fields(packed: torch.Tensor, albedo: torch.Tensor, light: torch.Tensor,
            bg: torch.Tensor):
    """(mat, hit, cont, E, F) of record planes (depth, n)."""
    mat = (packed & 0xFFFF).long()
    hit = (packed & HIT_BIT) != 0
    cont = ((packed & CONT_BIT) != 0)[..., None]
    miss = ((packed & MISS_BIT) != 0)[..., None]
    a = albedo[mat]
    emit = torch.where((hit & light[mat])[..., None], a, 0.0)
    e = torch.where(miss, bg, emit)
    f = torch.where(cont, a, 1.0)
    return mat, hit, cont, e, f


def shade(packed: torch.Tensor, scene: Scene,
          albedo: torch.Tensor) -> torch.Tensor:
    """The radiance (n, 3) of the paths of record planes (depth, n)."""
    light, bg = _tables(scene, albedo)
    _, _, _, e, f = _fields(packed, albedo, light, bg)
    rad = torch.zeros(e.shape[1:], dtype=albedo.dtype, device=albedo.device)
    t = torch.ones_like(rad)
    for b in range(packed.shape[0]):
        rad = rad + t * e[b]
        t = t * f[b]
    return rad


def _tables(scene: Scene, albedo: torch.Tensor):
    light = torch.tensor([k == DIFFUSE_LIGHT for k in scene.kinds],
                         device=albedo.device)
    bg = torch.tensor(scene.background, dtype=albedo.dtype,
                      device=albedo.device)
    return light, bg


def albedo_grad(packed: torch.Tensor, scene: Scene, albedo: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """d<g, L> / d albedo, (M, 3), for record planes (depth, n) and the
    radiance cotangent g (n, 3); a float32 run sums the terms in
    float64."""
    light, bg = _tables(scene, albedo)
    mat, hit, cont, e, f = _fields(packed, albedo, light, bg)
    depth = packed.shape[0]
    t = [torch.ones_like(g)]
    for b in range(depth - 1):
        t.append(t[-1] * f[b])
    s_next = torch.zeros_like(g)
    acc = torch.float64 if albedo.dtype == torch.float32 else albedo.dtype
    grad = torch.zeros(albedo.shape, dtype=acc, device=albedo.device)
    for b in range(depth - 1, -1, -1):
        gt = g * t[b]
        g_att = torch.where(cont[b], gt * s_next, 0.0)
        g_emit = torch.where((hit[b] & light[mat[b]])[..., None], gt, 0.0)
        grad.index_add_(0, mat[b], (g_att + g_emit).to(acc))
        s_next = e[b] + f[b] * s_next
    return grad.to(albedo.dtype)


class Adam:
    """Adam with torch's defaults (betas 0.9, 0.999, eps 1e-8)."""

    def __init__(self, params: dict, lr: float):
        self.lr, self.t = float(lr), 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        b1, b2 = BETAS
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1.0 - b1) * g
            self.v[k] = b2 * self.v[k] + (1.0 - b2) * g * g
            m_hat = self.m[k] / (1.0 - b1 ** self.t)
            v_hat = self.v[k] / (1.0 - b2 ** self.t)
            out[k] = p - self.lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
        return out


def l2_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mean((img - target) ** 2)."""
    return torch.mean((img - target) ** 2)


def loss_cotangent(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """d l2_loss / d img."""
    return (img - target) * (2.0 / img.numel())

