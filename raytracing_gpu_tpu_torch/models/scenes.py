"""Scene registry (counterpart of `raytracing_gpu_tpu/models/scenes.py`).

All 13 scenes of the JAX registry.  Camera parameters, materials and
geometry are transcribed from the same reference lines as the JAX package
(`raytracing_gpu_tpu/models/scenes.py:60-316`); `big_scene1` draws its
layout from the same numpy generator and seed, so its tables equal the JAX
package's.

The image assets are read from the reference assets under
`$RT_REFERENCE_ASSETS` only, and each scene keeps the JAX package's
fallback when they are absent: `earth` takes `textures/earthmap.jpg`, or
the solid (0, 1, 1); the mesh scenes (`door`, `backpack`, `cup`) take
their OBJ through `io.obj` with one lambertian image texture per submesh,
or, without the OBJ, the procedural stand-in (a 224 x 224 UV sphere of
100,352 triangles sized to the scene's framing) with the asset's diffuse
map subsampled to at most 1024 texels a side, or the solid (0.8, 0.2, 0.2)
without it.  `earth(image)` and `backpack_standin(res, texture)` take an
image array instead, for a machine without the assets.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

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


def _reference_root() -> Optional[str]:
    return os.environ.get("RT_REFERENCE_ASSETS")


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


@register("earth")
def earth(image: Optional[np.ndarray] = None) -> SceneDef:
    """reference `create_earth_world` (`scenes.h:278-320`): an image-
    textured sphere and an emissive rect on black.  The texture is `image`
    ((H, W, 3) in [0, 1]) when given, else `textures/earthmap.jpg` under
    the reference assets when it exists, else the solid (0, 1, 1), as the
    JAX package falls back."""
    b = SceneBuilder(background=BLACK)
    root = _reference_root()
    path = (None if root is None
            else os.path.join(root, "textures", "earthmap.jpg"))
    if image is not None:
        tex = b.image(image)
    elif path is not None and os.path.exists(path):
        tex = b.image(path)
    else:
        tex = b.solid((0, 1, 1))
    b.sphere((0, 0, 0), 2, b.lambertian(tex))
    b.rect("xy", -5, 5, -3, 3, 6, b.diffuse_light((4.0, 4.0, 4.0)))
    cam = _cam((13, 0, 3), (0, 0, 0), 20, 16 / 9, aperture=0.1)
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


@register("triangle")
def triangle_scene() -> SceneDef:
    """reference `create_triangle_world` (`scenes.h:409-428`)."""
    b = SceneBuilder(background=SKY)
    b.triangle((-0.5, 0, 0), (0, 1, 10), (0.0, 0, 0), b.lambertian((0, 1, 0)),
               uv0=(0, 0), uv1=(0, 1), uv2=(1, 0))
    b.sphere((0, -100.5, -1), 100, b.lambertian((0, 0, 1)))
    return SceneDef(b.build(), _cam((0, 0, -3), (0, 0, 0), 40, 16 / 9),
                    16 / 9)


@register("triangles")
def triangles_scene() -> SceneDef:
    """reference `create_triangles_world` (`scenes.h:432-475`)."""
    b = SceneBuilder(background=SKY)
    uv = dict(uv0=(0, 0), uv1=(0, 1), uv2=(1, 0))
    b.triangle((-0.5, 0, 0), (0, 1, 10), (0.5, 0, 0), b.lambertian((0, 1, 0)),
               **uv)
    b.triangle((0.5, 0, 0), (0, 1, 10), (0.5, 1, 0), b.lambertian((1, 1, 0)),
               **uv)
    b.triangle((1.5, 0, 0), (0, 2, 10), (1.5, 1, 0), b.lambertian((1, 1, 1)),
               **uv)
    b.triangle((1.5, 0, 0), (1.5, 1, 10), (1.5, 0, 2),
               b.lambertian((1, 1, 1)), **uv)
    b.sphere((0, -100.5, -1), 100, b.lambertian((0, 0, 1)))
    return SceneDef(b.build(), _cam((0, 0, -3), (0, 0, 0), 40, 16 / 9),
                    16 / 9)


def _add_obj(b: SceneBuilder, asset: tuple, diffuse: tuple,
             standin_scale: float = 1.0) -> None:
    """A mesh asset, as the JAX package's `_add_obj` adds it
    (`models/scenes.py:218-252`): the OBJ at `asset` (path parts under the
    reference assets) through `io.obj`, one lambertian per submesh with its
    `map_Kd` image or its `Kd` color (`triangle_mesh.h:147-204`); without
    the OBJ, the procedural stand-in (`_standin_mesh`) with the diffuse map
    `diffuse`, subsampled to at most 1024 texels a side (every step-th
    texel of each axis), or with a solid texture when the map is missing
    too."""
    root = _reference_root()
    path = None if root is None else os.path.join(root, *asset)
    if path is not None and os.path.exists(path):
        from ..io.obj import load_obj

        for sub in load_obj(path).submeshes:
            if sub.diffuse_texture is not None:
                mat = b.lambertian(b.image(sub.diffuse_texture))
            else:
                mat = b.lambertian(sub.diffuse_color)
            b.mesh(sub.vertices, sub.faces, mat, uvs=sub.uvs,
                   normals=sub.normals)
        return
    fallback = None if root is None else os.path.join(root, *diffuse)
    texture = None
    if fallback is not None and os.path.exists(fallback):
        from ..io.images import load_image

        texture = load_image(fallback)
    _standin_mesh(b, (224, 224), standin_scale, texture)


def _standin_mesh(b: SceneBuilder, res: tuple, scale: float,
                  texture: Optional[np.ndarray] = None) -> None:
    """A UV sphere of `res` (224 x 224 gives 100,352 triangles, the scale
    of the real backpack and cup) sized to the scene's framing and resting
    on y = 0, lambertian with the image `texture` ((H, W, 3) in [0, 1]),
    subsampled by `img[::step, ::step]` to at most 1024 texels a side, or
    with the solid texture (0.8, 0.2, 0.2) when it is None."""
    if texture is None:
        tex = b.solid((0.8, 0.2, 0.2))
    else:
        step = max(1, (max(texture.shape[:2]) + 1023) // 1024)
        tex = b.image(texture[::step, ::step])
    v, f, uvs, n = _uv_sphere(*res)
    v = v * scale
    v[:, 1] += scale
    b.mesh(v, f, b.lambertian(tex), uvs=uvs, normals=n)


def _uv_sphere(n_lat: int, n_lon: int, radius: float = 1.0):
    """Procedural UV-sphere mesh: (vertices, faces, uvs, normals), two
    triangles per latitude-longitude cell, in the JAX package's order."""
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon + 1)
    tt, pp = np.meshgrid(lat, lon, indexing="ij")
    x = radius * np.sin(tt) * np.cos(pp)
    y = radius * np.cos(tt)
    z = radius * np.sin(tt) * np.sin(pp)
    v = np.stack((x, y, z), -1).reshape(-1, 3)
    uvs = np.stack((pp / (2 * np.pi), 1.0 - tt / np.pi), -1).reshape(-1, 2)
    normals = v / radius
    idx = np.arange((n_lat + 1) * (n_lon + 1)).reshape(n_lat + 1, n_lon + 1)
    a, b = idx[:-1, :-1], idx[1:, :-1]
    c, d = idx[1:, 1:], idx[:-1, 1:]
    faces = np.stack((np.stack((a, b, c), -1), np.stack((a, c, d), -1)),
                     axis=2).reshape(-1, 3)
    return (v.astype(np.float32), faces, uvs.astype(np.float32),
            normals.astype(np.float32))


@register("door")
def door_scene() -> SceneDef:
    """reference `door_scene` (`scenes.h:478-523`): door.obj mesh + ground."""
    b = SceneBuilder(background=SKY)
    _add_obj(b, ("assets", "door", "door.obj"),
             ("assets", "door", "Door_C.jpg"))
    b.sphere((0, -100, -1), 100, b.lambertian((0, 1, 0)))
    return SceneDef(b.build(), _cam((-3, 4, -5), (0, 1, 0), 20, 16 / 9),
                    16 / 9)


@register("backpack")
def backpack_scene() -> SceneDef:
    """reference `backpack_scene` (`scenes.h:526-572`), BASELINE config 5:
    the mesh and the ground (the reference build overwrites the mesh with
    the ground sphere; the JAX package builds the intended scene)."""
    b = SceneBuilder(background=SKY)
    _add_obj(b, ("assets", "backpack", "backpack.obj"),
             ("assets", "backpack", "diffuse.jpg"), standin_scale=0.45)
    b.sphere((0, -100, -1), 100, b.lambertian((0, 1, 0)))
    return SceneDef(b.build(), _cam((0, 0, -3), (0, 0, 0), 20, 16 / 9),
                    16 / 9)


def backpack_standin(res: tuple = (224, 224),
                     texture: Optional[np.ndarray] = None) -> SceneDef:
    """The backpack scene with its procedural stand-in at `res` (`backpack`
    itself when the assets are absent and `res` is (224, 224)), with the
    diffuse map `texture` as `_add_obj` adds one from a file: smaller
    meshes of the same framing for tests and the pinned goldens
    (`tools/make_torch_goldens.py` builds the same one in the JAX
    package), and BASELINE config 5 with a map on a machine without the
    assets."""
    b = SceneBuilder(background=SKY)
    _standin_mesh(b, res, 0.45, texture)
    b.sphere((0, -100, -1), 100, b.lambertian((0, 1, 0)))
    return SceneDef(b.build(), _cam((0, 0, -3), (0, 0, 0), 20, 16 / 9),
                    16 / 9)


@register("cup")
def cup_scene() -> SceneDef:
    """reference `cup_scene` (`scenes.h:576-621`)."""
    b = SceneBuilder(background=SKY)
    _add_obj(b, ("assets", "cup", "cup.obj"),
             ("assets", "cup", "MaryRoseTankard_100kMesh.jpg"),
             standin_scale=0.12)
    b.sphere((0, -100, -1), 100, b.lambertian((0, 1, 0)))
    return SceneDef(b.build(), _cam((0, 0, -1), (0, 0, 0), 20, 16 / 9),
                    16 / 9)
