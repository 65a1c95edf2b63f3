"""Scene registry (counterpart of `raytracing_gpu_tpu/models/scenes.py`).

Only the scenes whose features the port covers are registered: `names()`
lists what renders here (no triangles, no image textures).  Camera
parameters, materials and geometry are transcribed from the same reference
lines as the JAX package (`raytracing_gpu_tpu/models/scenes.py:60-190`);
`big_scene1` draws its layout from the same numpy generator and seed, so
its tables equal the JAX package's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from ..core.camera import Camera
from ..scene.builder import BLACK, SKY, SceneBuilder
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


@register("basic")
def basic_scene() -> SceneDef:
    """reference `create_basic_world` (`scenes.h:82-100`)."""
    b = SceneBuilder(background=SKY)
    b.sphere((0, 0, -1), 0.5, b.lambertian((0, 1, 0)))
    b.sphere((0, -100.5, -1), 100, b.lambertian((0, 0, 1)))
    return SceneDef(b.build(), _cam((0, 0, -3), (0, 0, 0), 40, 16 / 9), 16 / 9)


@register("first")
def first_scene() -> SceneDef:
    """reference `create_first_world` (`scenes.h:106-137`), with the hollow
    glass sphere made by a negative radius."""
    b = SceneBuilder(background=SKY)
    ground = b.lambertian((0.8, 0.8, 0.0))
    center = b.lambertian((0.1, 0.2, 0.3))
    left = b.dielectric(2.5)
    right = b.metal((0.8, 0.6, 0.2), 0.2)
    front = b.dielectric(2.0)
    b.sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.sphere((0.0, 0.0, -1.0), 0.5, center)
    b.sphere((-1.0, 0.0, -1.0), 0.5, left)
    b.sphere((1.0, 0.0, -1.0), 0.5, right)
    b.sphere((0.0, 1.0, -0.75), 0.25, front)
    b.sphere((0.0, 1.0, -0.75), -0.25, front)
    return SceneDef(b.build(), _cam((-2, 2, -3), (0, 0, -1), 20, 16 / 9),
                    16 / 9)


@register("big_scene1")
def big_scene1() -> SceneDef:
    """RTOW cover scene, reference `create_big_world1` (`scenes.h:140-222`):
    checkered ground, 22x22 random spheres (80% moving lambertian, 15%
    metal, 5% glass) and three hero spheres, thin-lens camera with aperture
    0.1.  The layout comes from `np.random.default_rng(1984)` in the JAX
    package's draw order (`models/scenes.py:88-116`)."""
    b = SceneBuilder(background=SKY)
    rng = np.random.default_rng(b.seed)
    checker = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.sphere((0, -1000, 0), 1000, b.lambertian(checker))
    for a in range(-11, 11):
        for c in range(-11, 11):
            choose = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2,
                               c + 0.9 * rng.random()])
            if np.sum((center - np.array([4, 0.2, 0])) ** 2) <= 0.9 * 0.9:
                continue  # the reference fills a dummy micro-sphere here
            if choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                center2 = center + np.array([0, rng.uniform(0, 0.5), 0])
                b.moving_sphere(center, center2, 0.0, 1.0, 0.2,
                                b.lambertian(albedo))
            elif choose < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)
                b.sphere(center, 0.2, b.metal(albedo, rng.uniform(0, 0.5)))
            else:
                b.sphere(center, 0.2, b.dielectric(1.5))
    b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((-4, 1, 0), 1.0, b.lambertian((0.4, 0.2, 0.1)))
    b.sphere((4, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))
    cam = _cam((13, 2, -3), (0, 0, 0), 20, 16 / 9, aperture=0.1)
    return SceneDef(b.build(), cam, 16 / 9)


@register("two_spheres")
def two_spheres() -> SceneDef:
    """reference `create_two_spheres_world` (`scenes.h:225-243`)."""
    b = SceneBuilder(background=SKY)
    checker = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    mat = b.lambertian(checker)
    b.sphere((0, -10, 0), 10, mat)
    b.sphere((0, 10, 0), 10, mat)
    cam = _cam((13, 2, 3), (0, 0, 0), 20, 16 / 9, aperture=0.1)
    return SceneDef(b.build(), cam, 16 / 9)


@register("two_perlin_spheres")
def two_perlin_spheres() -> SceneDef:
    """reference `create_two_perlin_spheres_world` (`scenes.h:248-274`)."""
    b = SceneBuilder(background=SKY)
    b.sphere((0, -1000, 0), 1000, b.lambertian(b.marble(4.0)))
    b.sphere((0, 2, 0), 2, b.lambertian(b.turbulence(5.0)))
    cam = _cam((13, 2, 3), (0, 0, 0), 20, 16 / 9, aperture=0.1)
    return SceneDef(b.build(), cam, 16 / 9)


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


@register("cornell_smoke")
def cornell_smoke() -> SceneDef:
    """reference `create_cornell_smoke_box_world` (`scenes.h:365-404`)."""
    b = SceneBuilder(background=BLACK)
    _cornell_walls(b, (113, 443, 127, 432))
    b.box_medium((0, 0, 0), (165, 330, 165), 0.01, (0, 0, 0),
                 rotate_y=15, translate=(265, 0, 295))
    b.box_medium((0, 0, 0), (165, 165, 165), 0.01, (1, 1, 1),
                 rotate_y=-18, translate=(130, 0, 65))
    cam = _cam((278, 278, -800), (278, 278, 0), 40, 1.0)
    return SceneDef(b.build(), cam, 1.0)
