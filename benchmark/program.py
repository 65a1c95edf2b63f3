"""The system under test: the port's scene, camera and settings of a
configuration file, built through the port's public builder.

This module and `generator.py` are the benchmark's only importers of
`raytracing_gpu_tpu_torch`.  The scene is made from the file's primitives
in the file's order (materials, rects, boxes, then the media, each of
which adds its isotropic material), so the port numbers its materials as
the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Program:
    scene: object
    camera: object
    settings: object


def build(config: dict) -> Program:
    """The port's (scene, camera, settings) of a configuration."""
    from raytracing_gpu_tpu_torch import Camera, RenderSettings, SceneBuilder

    spec = config["scene"]
    b = SceneBuilder(background=tuple(spec["background"]))
    mats = {}
    for name, m in spec["materials"].items():
        make = {"lambertian": b.lambertian,
                "diffuse_light": b.diffuse_light}[m["kind"]]
        mats[name] = make(tuple(m["albedo"]))
    for r in spec.get("rects", []):
        b.rect(r["plane"], r["a0"], r["a1"], r["b0"], r["b1"], r["k"],
               mats[r["material"]])
    for x in spec.get("boxes", []):
        b.box(tuple(x["p0"]), tuple(x["p1"]), mats[x["material"]],
              rotate_y=x.get("rotate_y", 0.0),
              translate=tuple(x.get("translate", (0, 0, 0))))
    for m in spec.get("media", []):
        b.box_medium(tuple(m["p0"]), tuple(m["p1"]), m["density"],
                     tuple(m["albedo"]), rotate_y=m.get("rotate_y", 0.0),
                     translate=tuple(m.get("translate", (0, 0, 0))))
    cam = config["camera"]
    camera = Camera.make(cam["lookfrom"], cam["lookat"], cam["vup"],
                         cam["vfov"], cam["aspect_ratio"], cam["aperture"],
                         cam["focus_dist"], cam["time0"], cam["time1"])
    return Program(scene=b.build(), camera=camera,
                   settings=RenderSettings(**config["settings"]))
