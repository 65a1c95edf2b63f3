"""raytracing_gpu_tpu_torch — the path tracer in PyTorch, with CUDA kernels
for NVIDIA Hopper.

The port of `raytracing_gpu_tpu` (JAX/Pallas on a TPU), module for module.
The JAX package stays the reference this package is tested against.  This
package imports torch and never JAX.  Its kernels are CUDA C++ in
`ops/csrc/`, built with nvcc for sm_90a at first use; on CPU tensors each
kernel's plain PyTorch version runs instead.

Ported, for every scene of the JAX package (rects, boxes, spheres in a
dense loop or a BVH, triangle meshes, up to 16 constant media; every
material; solid, checker, perlin and image textures; russian roulette):
the forward render (`render`, `compile_renderer`) and the differentiable
chunks that training runs (`compile_fused_param_renderer`: the
megakernel's record mode, then the shading and its closed-form adjoint in
torch; `compile_param_renderer`: that chunk on ray planes, or the
wavefront record walk and the shading under autograd).  Image textures
are read by the torch shade from the flat atlas, whose texels are a
differentiable parameter (`atlas_data`).
"""

from .core.camera import Camera
from .core.config import RenderSettings
from .engine.fused_diff import compile_fused_param_renderer
from .engine.render import (compile_param_renderer, compile_renderer, render,
                            render_linear)
from .scene.builder import BLACK, SKY, SceneBuilder

__all__ = [
    "Camera",
    "RenderSettings",
    "SceneBuilder",
    "SKY",
    "BLACK",
    "compile_fused_param_renderer",
    "compile_param_renderer",
    "compile_renderer",
    "render",
    "render_linear",
]

__version__ = "0.1.0"
