"""Synthetic image textures, and the scenes that probe the image paths.

The reference's image assets (`earthmap.jpg`, the OBJ meshes and their
diffuse maps) are not part of the repository, so the image paths are
driven with images made from a seed: smooth structure plus per-texel noise,
so that a nearest-texel lookup and the atlas's gradient vary from texel to
texel, quantized to k/255 as a decoded 8-bit image is.

Each scene function takes the builder and camera classes, so that the
port (`scene.builder.SceneBuilder`, `core.camera.Camera`) and the JAX
package build the same scene from the same arrays; each returns (scene,
camera, aspect).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from .scenes import _uv_sphere


def synthetic_image(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) float32 in [0, 1] from `seed`: a few sine gratings per
    channel plus uniform per-texel noise, quantized to k/255 and divided as
    `io.images.load_image` divides a decoded 8-bit image."""
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.linspace(0.0, 1.0, h), np.linspace(0.0, 1.0, w),
                       indexing="ij")
    img = np.empty((h, w, 3))
    for c in range(3):
        fx, fy = rng.uniform(1.0, 4.0, 2)
        img[..., c] = 0.5 + 0.35 * np.sin(
            2 * math.pi * (fx * x + fy * y) + rng.uniform(0, 2 * math.pi))
    img += rng.uniform(-0.12, 0.12, (h, w, 3))
    k = np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    return k.astype(np.float32) / 255.0


def _make_cam(camera_cls, lookfrom, lookat, vfov, aspect):
    return camera_cls.make(lookfrom, lookat, (0, 1, 0), vfov, aspect, 0.0,
                           10.0, 0.0, 1.0)


def image_probe(builder_cls, camera_cls,
                images: Optional[Sequence[np.ndarray]] = None,
                mesh_res: tuple = (16, 32)) -> tuple:
    """Every uv path of the record walk in one Cornell-style box: two
    different images on the back wall and the floor (rect uv), an
    image-textured box (whose record uv is the closest rect's, the
    reference quirk), a box medium (uv 0), a dense image sphere under
    rotate_y 30 (its uv phase -1/12 wraps), and a small image mesh of
    2 * 16 * 32 = 1,024 triangles (interpolated uv)."""
    back, floor = (images if images is not None
                   else (synthetic_image(48, 64, 1),
                         synthetic_image(40, 40, 2)))
    b = builder_cls(background=(0.0, 0.0, 0.0))
    back_tex, floor_tex = b.image(back), b.image(floor)
    red = b.lambertian((0.65, 0.05, 0.05))
    green = b.lambertian((0.12, 0.45, 0.15))
    white = b.lambertian((0.73, 0.73, 0.73))
    b.rect("yz", 0, 555, 0, 555, 555, green)
    b.rect("yz", 0, 555, 0, 555, 0, red)
    b.rect("xz", 213, 343, 227, 332, 554, b.diffuse_light((15, 15, 15)))
    b.rect("xz", 0, 555, 0, 555, 0, b.lambertian(floor_tex))
    b.rect("xz", 0, 555, 0, 555, 555, white)
    b.rect("xy", 0, 555, 0, 555, 555, b.lambertian(back_tex))
    b.box((0, 0, 0), (165, 330, 165), b.lambertian(back_tex), rotate_y=15,
          translate=(265, 0, 295))
    b.box_medium((0, 0, 0), (165, 165, 165), 0.01, (1.0, 1.0, 1.0),
                 rotate_y=-18, translate=(130, 0, 65))
    b.sphere((0, 0, 0), 80, b.lambertian(floor_tex), rotate_y=30,
             translate=(420, 90, 120))
    v, f, uvs, n = _uv_sphere(*mesh_res)
    b.mesh(v, f, b.lambertian(back_tex), uvs=uvs, normals=n, scale=70.0,
           translate=(170, 400, 250))
    cam = _make_cam(camera_cls, (278, 278, -800), (278, 278, 0), 40, 1.0)
    return b.build(), cam, 1.0


def image_spheres(builder_cls, camera_cls,
                  images: Optional[Sequence[np.ndarray]] = None,
                  n: int = 70) -> tuple:
    """`n` image-textured spheres of radius 0.2 on an image-textured ground
    sphere, under a 16:9 camera (the geometry of
    `tools/make_torch_goldens.py`'s `perlin_field`, with two images for its
    noise and colors): more than 64 spheres, so a sphere BVH.  Sphere i
    turns by 13 i degrees about y, so its uv phases wrap."""
    ground, ball = (images if images is not None
                    else (synthetic_image(64, 128, 3),
                          synthetic_image(32, 64, 4)))
    b = builder_cls()
    g_tex, s_tex = b.image(ground), b.image(ball)
    b.sphere((0, -1000, 0), 1000, b.lambertian(g_tex))
    for i in range(n):
        x, z = i % 10 - 4.5, i // 10 - 3.0
        b.sphere((0, 0, 0), 0.2, b.lambertian(s_tex if i % 2 else g_tex),
                 rotate_y=13.0 * i, translate=(0.8 * x, 0.2, 0.8 * z))
    return b.build(), _make_cam(camera_cls, (0, 3, 7), (0, 0, 0), 40,
                                16 / 9), 16 / 9


def image_mesh(builder_cls, camera_cls, image: Optional[np.ndarray] = None,
               res: tuple = (16, 16)) -> tuple:
    """The backpack scene's framing with a `res` UV sphere (16 x 16: 512
    triangles) carrying `image`, on the backpack's ground sphere, as
    `models/scenes.py` builds the stand-in with a diffuse map."""
    image = synthetic_image(64, 64, 5) if image is None else image
    b = builder_cls(background=(0.7, 0.8, 1.0))
    v, f, uvs, n = _uv_sphere(*res)
    v = v * 0.45
    v[:, 1] += 0.45
    b.mesh(v, f, b.lambertian(b.image(image)), uvs=uvs, normals=n)
    b.sphere((0, -100, -1), 100, b.lambertian((0, 1, 0)))
    return b.build(), _make_cam(camera_cls, (0, 0, -3), (0, 0, 0), 20,
                                16 / 9), 16 / 9


def tie_mesh(builder_cls, camera_cls, copies: int = 40) -> tuple:
    """Exact ties for the triangle walks: triangle A twice (two slots of
    one leaf) and triangle B `copies` times (more than a hit-tier leaf of
    28 holds, so its copies fill several leaves of both tiers), side by
    side in front of a wall of two triangles.  A ray that hits A or B
    meets all its copies at one distance, and the walk keeps the first it
    tests: the lowest slot of the first leaf it visits."""
    b = builder_cls(background=(0.7, 0.8, 1.0))
    red = b.lambertian((0.65, 0.05, 0.05))
    green = b.lambertian((0.12, 0.45, 0.15))
    white = b.lambertian((0.73, 0.73, 0.73))
    wall = np.array([[-4, -3, -2], [4, -3, -2], [4, 3, -2], [-4, 3, -2]],
                    np.float32)
    b.mesh(wall, np.array([[0, 1, 2], [0, 2, 3]]), white)
    tri_a = np.array([[-2.0, -1.0, 0.0], [-0.2, -1.0, 0.0], [-1.1, 1.2, 0.0]],
                     np.float32)
    b.mesh(np.concatenate([tri_a, tri_a]), np.array([[0, 1, 2], [3, 4, 5]]),
           red)
    tri_b = np.array([[0.2, -1.0, 0.5], [2.0, -1.0, 0.5], [1.1, 1.2, 0.5]],
                     np.float32)
    b.mesh(np.tile(tri_b, (copies, 1)),
           np.arange(3 * copies).reshape(copies, 3), green)
    cam = _make_cam(camera_cls, (0, 0, 6), (0, 0, 0), 40, 16 / 9)
    return b.build(), cam, 16 / 9


def many_media(builder_cls, camera_cls, n: int = 20) -> tuple:
    """`n` constant media, more than the kernels' 16 (`MAX_MEDIA`), in a
    lit Cornell box with one solid box: spheres and boxes of fog in turn,
    of several densities and colors, on a 5-wide grid over the floor.  No
    kernel renders it, so the "auto" engine takes the xla route."""
    b = builder_cls(background=(0.0, 0.0, 0.0))
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    b.rect("yz", 0, 555, 0, 555, 555, green)
    b.rect("yz", 0, 555, 0, 555, 0, red)
    b.rect("xz", 113, 443, 127, 432, 554, b.diffuse_light((7.0, 7.0, 7.0)))
    b.rect("xz", 0, 555, 0, 555, 0, white)
    b.rect("xz", 0, 555, 0, 555, 555, white)
    b.rect("xy", 0, 555, 0, 555, 555, white)
    b.box((0, 0, 0), (120, 240, 120), white, rotate_y=20,
          translate=(300, 0, 380))
    for i in range(n):
        x, z = 70 + 100 * (i % 5), 60 + 110 * (i // 5 % 4)
        y = 60 + 90 * (i // 20)
        color = ((i * 37 % 10) / 10, (i * 53 % 10) / 10, (i * 71 % 10) / 10)
        density = 0.004 + 0.004 * (i % 4)
        if i % 2:
            b.sphere_medium((x, y, z), 45, density, color)
        else:
            b.box_medium((0, 0, 0), (80, 80, 80), density, color,
                         rotate_y=15.0 * i, translate=(x - 40, y - 40, z - 40))
    cam = _make_cam(camera_cls, (278, 278, -800), (278, 278, 0), 40, 1.0)
    return b.build(), cam, 1.0


def mesh_box(builder_cls, camera_cls) -> tuple:
    """A closed box made only of triangles, the camera inside it: a
    white floor, ceiling, back and front wall, a red and a green side wall
    (two triangles a face) and a two-triangle light under the ceiling.  No
    ray leaves the box, so a path ends only at the depth limit or by
    russian roulette: the triangle walk (kernel 1d-t) at depth 50 runs
    paths long past bounce 4."""
    b = builder_cls(background=(0.0, 0.0, 0.0))
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light((4.0, 4.0, 4.0))
    quad = np.array([[0, 1, 2], [0, 2, 3]])

    def face(corners, mat):
        b.mesh(np.array(corners, np.float32), quad, mat)

    face([[-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1]], white)
    face([[-1, 1, -1], [-1, 1, 1], [1, 1, 1], [1, 1, -1]], white)
    face([[-1, -1, -1], [-1, 1, -1], [1, 1, -1], [1, -1, -1]], white)
    face([[-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], white)
    face([[-1, -1, -1], [-1, -1, 1], [-1, 1, 1], [-1, 1, -1]], red)
    face([[1, -1, -1], [1, 1, -1], [1, 1, 1], [1, -1, 1]], green)
    face([[-0.3, 0.99, -0.3], [0.3, 0.99, -0.3], [0.3, 0.99, 0.3],
          [-0.3, 0.99, 0.3]], light)
    return b.build(), _make_cam(camera_cls, (0, 0, 0.9), (0, 0, -1), 70,
                                1.0), 1.0
