"""Back-to-back renders of one configuration through the port's `render()`.

A request is the chunks, the sums' copy to the host, the finished image
and its 8-bit form, with its own seed drawn from the run's seed.  The
traffic file gives `check_pixels` (pixels drawn from the seed whose
values are kept from every request) and `check_requests` (requests of
the window the comparison checks).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import check, generator, peaks
from ..reference import paths

KIND = "render"


class Load:
    """Back-to-back renders of one configuration."""

    kind = KIND

    def __init__(self, prog, traffic: dict, rng: np.random.Generator,
                 device: torch.device):
        self.prog, self.rng, self.device = prog, rng, device
        st = prog.settings
        self.npix = st.image_width * st.image_height
        self.rays = self.npix * st.rays_per_pixel
        k = min(int(traffic["check_pixels"]), self.npix)
        self.pix = np.sort(rng.choice(self.npix, size=k, replace=False))

    def warm(self) -> None:
        """One render of one chunk: every kernel and shape of a request."""
        from raytracing_gpu_tpu_torch import render
        from raytracing_gpu_tpu_torch.engine import film

        img = render(self.prog.scene, self.prog.camera,
                     self.prog.settings.with_(num_chunks=1),
                     seed=int(self.rng.integers(generator.SEED_RANGE)),
                     device=self.device)
        film.to_uint8(img)

    def request(self, spans: bool = False) -> dict:
        """One render; its seed, wall time, the port's build and trace
        phases, and the kept pixels."""
        from raytracing_gpu_tpu_torch import render
        from raytracing_gpu_tpu_torch.engine import film
        from raytracing_gpu_tpu_torch.utils.profiling import PhaseTimer

        seed = int(self.rng.integers(generator.SEED_RANGE))
        timer = PhaseTimer()
        t0 = time.perf_counter()
        img = render(self.prog.scene, self.prog.camera, self.prog.settings,
                     seed=seed, device=self.device, timer=timer)
        u8 = film.to_uint8(img)
        t1 = time.perf_counter()
        return dict(t0=t0, t1=t1, rays=self.rays, seed=seed,
                    build=timer.phases.get("build", 0.0),
                    trace=timer.phases.get("trace", 0.0),
                    img=img.reshape(-1, 3)[self.pix].copy(),
                    u8=u8.reshape(-1, 3)[self.pix].copy())

    def free(self) -> None:
        self.prog = None


def setup(prog, cfg: dict, traffic: dict, rng: np.random.Generator,
          device: torch.device, phase, plant=None) -> Load:
    """The load, warmed by one one-chunk render."""
    load = Load(prog, traffic, rng, device)
    if plant:
        plant(load)
    load.warm()
    generator.sync(device)
    phase("warm_up")
    return load


def _work(cfg: dict, counts: dict, rays: int) -> tuple:
    """(operations, bytes) of a render's chunk launches (`peaks`)."""
    st = cfg["settings"]
    h = int(st["image_width"] / st["aspect_ratio"])
    sc, _, geom = check.reference_parts(cfg, h, st["image_width"],
                                        st["ray_batch"])
    return peaks.render_work(len(sc.rects), len(sc.boxes), len(sc.media),
                             counts, rays, st["num_chunks"], geom.rows)


def judge(load: Load, items: list, cfg: dict, traffic: dict, seed: int,
          device: torch.device) -> tuple:
    """(numbers compared, a render's counted work): the kept pixels of
    requests drawn from the seed against the reference's, which runs once
    the load is freed."""
    pix = load.pix
    chosen = check.pick(len(items), int(traffic["check_requests"]), seed)
    got = [(items[i]["img"], items[i]["u8"]) for i in chosen]
    generator.release(load, device)
    counts = paths.zero_counts()
    want = check.render_reference(cfg, pix, [items[i]["seed"]
                                             for i in chosen],
                                  device, counts=counts)
    return (check.render_numbers(got, want),
            _work(cfg, counts, items[0]["rays"]))


def control_numbers(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The bfloat16 reference in the port's place, at the pixels and on
    the requests a run with this seed would check."""
    st = cfg["settings"]
    rng = np.random.default_rng(seed)
    npix = int(st["image_width"] / st["aspect_ratio"]) * st["image_width"]
    k = min(int(traffic["check_pixels"]), npix)
    pix = np.sort(rng.choice(npix, size=k, replace=False))
    rng.integers(generator.SEED_RANGE)  # the warm-up render's seed
    n = max(2, int(traffic["check_requests"]))
    seeds = [int(rng.integers(generator.SEED_RANGE)) for _ in range(n)]
    seeds = [seeds[i] for i in check.pick(n, int(traffic["check_requests"]),
                                          seed)]
    want = check.render_reference(cfg, pix, seeds, device)
    got = check.render_reference(cfg, pix, seeds, device,
                                 dtype=torch.bfloat16)
    return check.render_numbers(got, want)


def _stale(load: Load) -> None:
    """Every render returns the first render's image."""
    request, first = load.request, {}

    def stale(spans=False):
        item = request(spans)
        first.setdefault("img", (item["img"], item["u8"]))
        item["img"], item["u8"] = first["img"]
        return item

    load.request = stale


def _half(load: Load) -> None:
    """A render of half its chunks, the mean taken over what is left."""
    st = load.prog.settings
    load.prog.settings = st.with_(num_chunks=max(1, st.num_chunks // 2))


def _alter(load: Load) -> None:
    """One added to the first wave's rows of every chunk's sums as the
    chunk is produced."""
    from raytracing_gpu_tpu_torch.ops import cuda_trace

    # the port's own binding, also when an earlier run of this process
    # planted the fault
    bind = getattr(_alter, "bind_chunk", cuda_trace.Tracer.bind_chunk)
    _alter.bind_chunk = bind

    def bind_altered(self, *args, **kwargs):
        launch = bind(self, *args, **kwargs)
        wave = args[6] if len(args) > 6 else kwargs["ray_batch"]

        def altered(base):
            out = launch(base)
            out[:wave] += 1.0
            return out

        return altered

    cuda_trace.Tracer.bind_chunk = bind_altered


PLANTS = {"stale": _stale, "half": _half, "alter": _alter}
