"""Differentiable rendering: the parameter dict, losses, gradients.

Counterpart of `raytracing_gpu_tpu/engine/diff.py`.  The JAX package's
scene is a pytree whose differentiable leaves `jax.grad` follows; the
port's scene is host numpy, so its differentiable values travel beside it
as a dict of float32 tensors: the texture colors (which include emitter
radiance through diffuse_light textures) and the image atlas.  A render
function here maps that dict to an image, and `torch.autograd` takes the
gradients.

Discrete structure (hit selection, sampled directions) is detached in the
record kernel, which gives the detached-sampling estimator of the JAX
package: unbiased for shading, emission and texture parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from ..scene.types import Scene

ParamDict = Dict[str, torch.Tensor]
PARAM_KEYS = ("tex_c1", "tex_c2", "atlas_data")


def get_params(scene: Scene, device: torch.device | str = "cuda"
               ) -> ParamDict:
    """The differentiable parameters, float32 tensors on `device`."""
    return {
        "tex_c1": torch.tensor(scene.textures.c1, dtype=torch.float32,
                               device=device),
        "tex_c2": torch.tensor(scene.textures.c2, dtype=torch.float32,
                               device=device),
        "atlas_data": torch.tensor(scene.atlas.data, dtype=torch.float32,
                                   device=device),
    }


def set_params(scene: Scene, params: ParamDict) -> Scene:
    """A copy of `scene` with the parameter values written into its host
    tables (detached, as float32 numpy)."""
    def host(name):
        return params[name].detach().to("cpu", torch.float32).numpy().copy()

    return dataclasses.replace(
        scene,
        textures=dataclasses.replace(scene.textures, c1=host("tex_c1"),
                                     c2=host("tex_c2")),
        atlas=dataclasses.replace(scene.atlas, data=host("atlas_data")),
    )


def l2_image_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((img - target) ** 2)


def make_loss_fn(render_fn: Callable[[ParamDict], torch.Tensor],
                 target: torch.Tensor, loss: Callable = l2_image_loss
                 ) -> Callable[[ParamDict], torch.Tensor]:
    """loss(params) for optimization: params -> image -> loss."""

    def fn(params: ParamDict) -> torch.Tensor:
        return loss(render_fn(params), target)

    return fn


def value_and_grad(params: ParamDict,
                   render_fn: Callable[[ParamDict], torch.Tensor],
                   target: torch.Tensor, loss: Callable = l2_image_loss):
    """(loss value, {name: gradient}) at `params`.  A parameter the render
    does not use gets a zero gradient of its own shape."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    value = make_loss_fn(render_fn, target, loss)(leaves)
    grads = torch.autograd.grad(value, list(leaves.values()),
                                allow_unused=True)
    return value.detach(), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(leaves.items(), grads)}

