"""Scene registry (counterpart of `raytracing_gpu_tpu/models/scenes.py`).

Only the scenes whose features the port covers are registered: `names()`
lists what renders here.  Camera parameters, materials and geometry are
transcribed from the same reference lines as the JAX package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from ..core.camera import Camera
from ..scene.builder import BLACK, SceneBuilder
from ..scene.types import Scene


class SceneDef(NamedTuple):
    scene: Scene
    camera: Camera
    aspect: float


_REGISTRY: dict[str, Callable[[], SceneDef]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def names() -> list[str]:
    return sorted(_REGISTRY)


def get(name: str) -> SceneDef:
    if name not in _REGISTRY:
        raise KeyError(f"scene {name!r} is not ported; ported scenes: "
                       f"{', '.join(names())}")
    return _REGISTRY[name]()


def _cam(lookfrom, lookat, vfov, aspect, aperture=0.0, focus=10.0) -> Camera:
    return Camera.make(lookfrom, lookat, (0, 1, 0), vfov, aspect, aperture,
                       focus, 0.0, 1.0)


def _cornell_walls(b: SceneBuilder, light_rect) -> int:
    """Walls + light shared by the Cornell scenes (`scenes.h:323-345`)."""
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light((15.0, 15.0, 15.0))
    b.rect("yz", 0, 555, 0, 555, 555, green)   # left wall
    b.rect("yz", 0, 555, 0, 555, 0, red)       # right wall
    b.rect("xz", *light_rect, 554, light)      # roof light
    b.rect("xz", 0, 555, 0, 555, 0, white)     # floor
    b.rect("xz", 0, 555, 0, 555, 555, white)   # roof
    b.rect("xy", 0, 555, 0, 555, 555, white)   # back wall
    return white


@register("cornell_box")
def cornell_box() -> SceneDef:
    """reference `create_cornell_box_world` (`scenes.h:323-360`)."""
    b = SceneBuilder(background=BLACK)
    white = _cornell_walls(b, (213, 343, 227, 332))
    b.box((0, 0, 0), (165, 330, 165), white, rotate_y=15, translate=(265, 0, 295))
    b.box((0, 0, 0), (165, 165, 165), white, rotate_y=-18, translate=(130, 0, 65))
    cam = _cam((278, 278, -800), (278, 278, 0), 40, 1.0)
    return SceneDef(b.build(), cam, 1.0)
