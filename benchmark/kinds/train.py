"""Back-to-back inverse-rendering steps on one training object.

A step is the port's differentiable chunk of `spp` samples of every pixel
in waves of `ray_batch` camera rays (the traffic's, which replaces the
configuration's render wave), the L2 loss of its mean
against a target image, the gradient of every parameter, an Adam step on
the device and the loss read back.  Set-up renders the target with the
reference at `target_spp` samples, starts the parameters from a
perturbation of `perturb` drawn from the seed, and runs the first
`check_steps` steps through the window's own call, keeping what the
comparison reads.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import check, generator
from ..reference import drive
from ..reference import scene as ref_scene

KIND = "train"


class Load:
    """One inverse-rendering run: the port's differentiable chunk, the
    parameters as leaves started from a perturbation drawn from the seed,
    and Adam on them."""

    kind = KIND

    def __init__(self, prog, traffic: dict, rng: np.random.Generator,
                 device: torch.device, target: torch.Tensor):
        from raytracing_gpu_tpu_torch.engine import diff
        from raytracing_gpu_tpu_torch.engine.fused_diff import (
            compile_fused_param_renderer)

        self.rng, self.device = rng, device
        self.scene, self.camera = prog.scene, prog.camera
        self.settings = prog.settings.with_(
            spp_per_chunk=int(traffic["spp"]), num_chunks=1,
            ray_batch=int(traffic["ray_batch"]))
        st = self.settings
        self.npix = st.image_width * st.image_height
        self.rays = self.npix * st.spp_per_chunk
        self.chunk = compile_fused_param_renderer(prog.scene, prog.camera,
                                                  st, device=device)
        self.target = target
        self.p0, self.factors = perturbed(diff.get_params(prog.scene, device),
                                          rng, float(traffic["perturb"]))
        self.params = {k: v.clone().requires_grad_(True)
                       for k, v in self.p0.items()}
        self.opt = Adam(list(self.params.values()), float(traffic["lr"]))
        self.bases = []
        self.kept = {}

    def loss(self, sums: torch.Tensor) -> torch.Tensor:
        """The L2 loss of the chunk's mean image against the target."""
        return torch.mean((sums[:self.npix] / self.settings.spp_per_chunk
                           - self.target) ** 2)

    def request(self, spans: bool = False) -> dict:
        """One step; its wall time and, with `spans`, the synchronized
        forward (chunk and loss) and backward (gradient and update)."""
        base = int(self.rng.integers(generator.SEED_RANGE))
        self.bases.append(base)
        t0 = time.perf_counter()
        sums = self.chunk(self.params, base)
        loss = self.loss(sums)
        if spans:
            generator.sync(self.device)
        tf = time.perf_counter()
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        value = loss.item()
        generator.sync(self.device)
        t1 = time.perf_counter()
        if len(self.bases) == 1:
            self.kept["sums"] = sums.detach().clone()
        return dict(t0=t0, t1=t1, rays=self.rays, base=base, loss=value,
                    fwd=(tf - t0) if spans else None,
                    bwd=(t1 - tf) if spans else None)

    def check_steps(self, n: int) -> list:
        """The first `n` steps, keeping the first step's sums, the first
        gradient as Adam holds it after that step, and the parameters
        after the n-th."""
        steps = []
        for k in range(n):
            steps.append(self.request())
            if k == 0:
                self.kept["grad"] = {name: self.opt.first_grad(i)
                                     for i, name in enumerate(self.params)}
        self.kept["params"] = {k: v.detach().clone()
                               for k, v in self.params.items()}
        self.kept["losses"] = [s["loss"] for s in steps]
        return steps

    def free(self) -> None:
        self.chunk = self.opt = self.params = self.scene = None


class Adam:
    """Adam with torch's defaults (betas 0.9 and 0.999, eps 1e-8), in
    place on the device.  Written out here because creating a
    `torch.optim` optimizer imports `torch._dynamo`, seconds of set-up in
    every run that no step needs."""

    betas, eps = (0.9, 0.999), 1e-8

    def __init__(self, params: list, lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.addcdiv_(m, (v / bc2).sqrt_().add_(self.eps),
                       value=-self.lr / bc1)

    def first_grad(self, i: int) -> torch.Tensor:
        """Parameter i's gradient of the first step, worked out from the
        first moment after it."""
        return (self.m[i] / (1.0 - self.betas[0])).detach().clone()


def perturbed(params: dict, rng: np.random.Generator, amount: float
              ) -> tuple:
    """(each parameter times its factors, the float32 factors): a factor
    an element, drawn uniformly from [1 - amount, 1 + amount]."""
    out, factors = {}, {}
    for k in sorted(params):
        v = params[k]
        factors[k] = torch.as_tensor(
            rng.uniform(1.0 - amount, 1.0 + amount, size=tuple(v.shape)),
            dtype=torch.float32)
        out[k] = v * factors[k].to(v.device)
    return out, factors


def _target(cfg: dict, traffic: dict, device) -> torch.Tensor:
    """The reference's target image at the scene's own parameters."""
    st = cfg["settings"]
    h = int(st["image_width"] / st["aspect_ratio"])
    sc, cam, geom = check.reference_parts(cfg, h, st["image_width"],
                                          traffic["ray_batch"])
    return drive.target_image(sc, cam, geom, st["seed"],
                              traffic["target_spp"], st["max_depth"],
                              st["t_min"], device)


def setup(prog, cfg: dict, traffic: dict, rng: np.random.Generator,
          device: torch.device, phase, plant=None) -> Load:
    """The target, the training object and its first checked steps,
    which are its warm-up."""
    target = _target(cfg, traffic, device)
    generator.sync(device)
    phase("target")
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    load = Load(prog, traffic, rng, device, target)
    if plant:
        plant(load)
    phase("program")
    load.check_steps(int(traffic["check_steps"]))
    phase("warm_up")
    return load


def judge(load: Load, items: list, cfg: dict, traffic: dict, seed: int,
          device: torch.device) -> tuple:
    """(numbers compared, None): the steps set-up kept against the
    reference's, which runs once the load is freed."""
    p0 = {k: v.detach().cpu() for k, v in load.p0.items()}
    kept = {k: ({n: x.cpu() for n, x in v.items()}
                if isinstance(v, dict) else v) for k, v in load.kept.items()}
    factors, target = load.factors, load.target
    bases = load.bases[:int(traffic["check_steps"])]
    generator.release(load, device)
    ref = check.train_reference(cfg, traffic, factors, target, bases)
    return check.train_numbers(kept, p0, ref), None


def control_numbers(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The bfloat16 reference in the port's place, from the perturbation
    and on the step bases a run with this seed draws."""
    rng = np.random.default_rng(seed)
    m = ref_scene.build_scene(cfg["scene"]).albedo.shape[0]
    shapes = {"atlas_data": torch.zeros(3), "tex_c1": torch.zeros(m, 3),
              "tex_c2": torch.zeros(m, 3)}
    _, factors = perturbed(shapes, rng, float(traffic["perturb"]))
    n = int(traffic["check_steps"])
    bases = [int(rng.integers(generator.SEED_RANGE)) for _ in range(n)]
    target = _target(cfg, traffic, device)
    ref = check.train_reference(cfg, traffic, factors, target, bases)
    low = check.train_reference(cfg, traffic, factors, target, bases,
                                dtype=torch.bfloat16)
    p0 = check.as_params(low["albedo0"], shapes)
    kept = {"losses": low["losses"], "sums": low["sums"].float(),
            "grad": check.as_params(low["grad"].float(), shapes),
            "params": check.as_params(low["albedo"].float(), shapes)}
    return check.train_numbers(kept, p0, ref)


def _unchanged(load: Load) -> None:
    """A step that leaves the parameters as they were."""
    load.opt.step = lambda *a, **k: None


def _half(load: Load) -> None:
    """A step of half its samples, the mean taken over what is left."""
    from raytracing_gpu_tpu_torch.engine.fused_diff import (
        compile_fused_param_renderer)

    spp = load.settings.spp_per_chunk
    if spp < 2:
        raise ValueError("half a step needs 2 samples or more")
    load.settings = load.settings.with_(spp_per_chunk=spp // 2)
    load.chunk = compile_fused_param_renderer(
        load.scene, load.camera, load.settings, device=load.device)


def _alter(load: Load) -> None:
    """One added to the first wave's rows of the step's sums as the chunk
    produces them."""
    chunk, wave = load.chunk, load.settings.ray_batch

    def altered(params, base):
        sums = chunk(params, base)
        shift = torch.zeros((sums.shape[0], 1), device=sums.device)
        shift[:wave] = 1.0
        return sums + shift

    load.chunk = altered


PLANTS = {"unchanged": _unchanged, "half": _half, "alter": _alter}
