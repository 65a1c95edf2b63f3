"""Entry points of the port (counterpart of `__graft_entry__.py`):
`entry`, a one-chunk compile check, and `dryrun_multichip`, one sharded
training step on a world of ranks held against the single-process one;
and `spawn`, which runs a function on a world of ranks under a deadline.

    python -m raytracing_gpu_tpu_torch.parallel.dryrun [--ranks N]
        [--device cpu|cuda]

A spawned rank is `python -m raytracing_gpu_tpu_torch.parallel.dryrun
--worker ...`: it joins the world's process group
(`distributed.initialize`, a TCP rendezvous on localhost), calls the
target with its device, saves what the target returns to a file and
leaves the group.  The parent kills every rank when the deadline passes,
and raises when a rank fails; the group's own timeout ends a rank whose
peer is missing or whose collective hangs.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import torch

from . import distributed

DEADLINE_S = 300.0
ENTRY = dict(image_width=64, aspect_ratio=1.0, spp_per_chunk=1,
             num_chunks=1, max_depth=4, ray_batch=4096)
# __graft_entry__.py:61-64 (spp 2 * n_sp) and :113-115
TRAIN = dict(image_width=64, aspect_ratio=1.0, num_chunks=1, max_depth=8,
             ray_batch=2048)
DOOR = dict(image_width=32, num_chunks=1, max_depth=3, ray_batch=256,
            rr_start=2)
LR = 1e-3
MODULE = f"{__package__}.dryrun"   # this module's name, also under -m


def entry(device: torch.device | str = "cuda"):
    """(fn, args): `fn(*args)` renders one chunk of the Cornell box (64x64,
    1 spp, depth 4, waves of 4,096 rays) on `device`, (npix_pad, 3) sums
    (`__graft_entry__.entry`)."""
    from ..core.config import RenderSettings
    from ..engine.render import compile_renderer
    from ..models import scenes

    sd = scenes.get("cornell_box")
    settings = RenderSettings(**ENTRY)

    def fn(scene, camera, base: int) -> torch.Tensor:
        return compile_renderer(scene, camera, settings, device)(base)

    return fn, (sd.scene, sd.camera, 0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(n: int, target: str, kwargs: Optional[dict] = None,
          device: str = "cpu", backend: Optional[str] = None,
          deadline: float = DEADLINE_S,
          timeout: float = distributed.TIMEOUT_S) -> list:
    """Run `target(device, **kwargs)` ("module:function", importable from
    this process's `sys.path`) on each of `n` ranks of a new world, and
    return what each rank's call returned, in rank order (tensors,
    numbers, strings and containers of them).

    The ranks join with `distributed.initialize` (backend `backend`, else
    `choose_backend` for `device` with all n ranks on this host) and a
    group timeout of `timeout` seconds (at most `deadline`): a rendezvous
    or a collective that waits longer fails its rank.  A rank that exits
    non-zero stops the others and raises RuntimeError with its output;
    when `deadline` seconds pass, every rank is killed and TimeoutError
    raised."""
    out = tempfile.mkdtemp(prefix="rt_world_")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p] + [env.get("PYTHONPATH", "")])
    port = free_port()
    timeout = min(timeout, deadline)
    logs, procs = [], []
    try:
        for r in range(n):
            logs.append(open(os.path.join(out, f"rank{r}.log"), "wb"))
            cmd = [sys.executable, "-m", MODULE, "--worker",
                   "--rank", str(r), "--world", str(n), "--port", str(port),
                   "--target", target, "--kwargs", json.dumps(kwargs or {}),
                   "--out", out, "--device", device, "--timeout",
                   str(timeout)]
            if backend is not None:
                cmd += ["--backend", backend]
            procs.append(subprocess.Popen(cmd, env=env, stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        t_end = time.monotonic() + deadline
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0]} of {n} failed:\n"
                                   + _tail(out, failed[0]))
            if time.monotonic() > t_end:
                raise TimeoutError(f"a world of {n} ranks ran past its "
                                   f"{deadline:.0f} s deadline:\n"
                                   + _tail(out, 0))
            time.sleep(0.05)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {n} failed:\n"
                                   + _tail(out, r))
        return [torch.load(os.path.join(out, f"rank{r}.pt"))
                for r in range(n)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()


def _tail(out: str, rank: int, nbytes: int = 4000) -> str:
    with open(os.path.join(out, f"rank{rank}.log"), "rb") as f:
        return f.read()[-nbytes:].decode(errors="replace")


def _worker(args) -> None:
    device = torch.device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    distributed.initialize(f"localhost:{args.port}", args.world, args.rank,
                           backend=args.backend, device=device,
                           timeout=args.timeout)
    try:
        device = distributed.rank_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        module, name = args.target.split(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(device, **json.loads(args.kwargs))
        torch.save(result, os.path.join(args.out, f"rank{args.rank}.pt"))
    finally:
        distributed.finalize()


def train_step_rank(device: torch.device) -> dict:
    """One rank of `dryrun_multichip`: one sharded training step (the
    fused chunk of the Cornell box on an (n_sp, n_dp) mesh, the L2 loss
    against a zero target, its gradients, one SGD step), then the sharded
    wavefront chunk of `door` (`__graft_entry__.py:39-127`)."""
    import torch.distributed as dist

    from ..core.config import RenderSettings
    from ..engine import diff
    from ..engine.fused_diff import compile_fused_param_renderer
    from ..models import scenes
    from .mesh import make_mesh
    from .render import compile_sharded_renderer

    n = dist.get_world_size() if dist.is_initialized() else 1
    n_sp = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n_sp=n_sp)
    sd = scenes.get("cornell_box")
    settings = RenderSettings(spp_per_chunk=2 * n_sp, **TRAIN)
    chunk = compile_fused_param_renderer(sd.scene, sd.camera, settings,
                                         gen_rays=False, device=device,
                                         mesh=mesh)
    npix = settings.num_pixels
    params = {k: v.requires_grad_(True)
              for k, v in diff.get_params(sd.scene, device).items()}
    loss = torch.mean(chunk(params, 0)[:npix] ** 2)
    loss.backward()
    grads = {k: v.grad.detach().clone() for k, v in params.items()}
    opt = torch.optim.SGD(list(params.values()), lr=LR)
    opt.step()
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError(f"non-finite sharded loss {float(loss)}")

    door = scenes.get("door")
    st2 = RenderSettings(aspect_ratio=door.aspect, spp_per_chunk=n_sp, **DOOR)
    wave = compile_sharded_renderer(door.scene, door.camera, st2, mesh,
                                    engine="pallas", device=device)
    if wave.engine_name != "wavefront":
        raise AssertionError(f"door takes {wave.engine_name}, not the "
                             "wavefront")
    frame = mesh.gather_dp(wave(0))
    return dict(n_sp=n_sp, loss=loss.detach().cpu(),
                grads={k: v.cpu() for k, v in grads.items()},
                stepped={k: v.detach().cpu() for k, v in params.items()},
                door=frame[:st2.num_pixels].cpu())


def dryrun_multichip(n: int, device: str = "cpu",
                     deadline: float = DEADLINE_S) -> dict:
    """One sharded training step on `n` spawned ranks
    (`__graft_entry__.dryrun_multichip`): `train_step_rank` on each, then
    `check_train_step` against the single-process chunks in this process.
    """
    return check_train_step(spawn(n, f"{MODULE}:train_step_rank",
                                  device=device, deadline=deadline),
                            device=device)


def train_step_reference(n_sp: int, device: str = "cpu") -> dict:
    """The single-process side of `train_step_rank` on `device`: the fused
    chunk of the Cornell box (64x64, 2 * n_sp spp, depth 8, waves of
    2,048), its L2 loss against a zero target and gradients, and the
    wavefront chunk of `door` (32 wide, n_sp spp, depth 3, waves of 256,
    `rr_start` 2)."""
    from ..core.config import RenderSettings
    from ..engine import diff
    from ..engine.fused_diff import compile_fused_param_renderer
    from ..engine.wavefront import compile_wavefront_renderer
    from ..models import scenes

    sd = scenes.get("cornell_box")
    settings = RenderSettings(spp_per_chunk=2 * n_sp, **TRAIN)
    single = compile_fused_param_renderer(sd.scene, sd.camera, settings,
                                          gen_rays=False, device=device)
    params = diff.get_params(sd.scene, device)
    npix = settings.num_pixels
    loss, grads = diff.value_and_grad(
        params, lambda p: single(p, 0)[:npix],
        torch.zeros(npix, 3, device=device))
    door = scenes.get("door")
    st2 = RenderSettings(aspect_ratio=door.aspect, spp_per_chunk=n_sp, **DOOR)
    frame = compile_wavefront_renderer(door.scene, door.camera, st2,
                                       device=device)(0)[:st2.num_pixels]
    return dict(loss=loss.cpu(), grads={k: v.cpu() for k, v in grads.items()},
                params={k: v.cpu() for k, v in params.items()},
                door=frame.cpu())


def check_train_step(ranks: list, ref: Optional[dict] = None,
                     device: str = "cpu") -> dict:
    """Hold each rank's `train_step_rank` result to `ref`
    (`train_step_reference`, computed on `device` when not given).  Raises
    unless, on every rank, the loss is within 1e-5 relative and every
    gradient within 1e-4 * its scale + 1e-10 of the single-process ones
    (`__graft_entry__.py:92-100`), the step is SGD's, and the wavefront
    chunk is within 1e-4 (`:116-127`).  Returns the loss and the largest
    errors."""
    if ref is None:
        ref = train_step_reference(ranks[0]["n_sp"], device)
    loss_1 = float(ref["loss"])
    report = dict(loss=loss_1, grad_err=0.0, door_err=0.0)
    for r, got in enumerate(ranks):
        loss = float(got["loss"])
        if abs(loss - loss_1) > 1e-5 * max(abs(loss_1), 1e-9):
            raise AssertionError(f"rank {r}: sharded loss {loss} != "
                                 f"single-process loss {loss_1}")
        for k, want in ref["grads"].items():
            err = float((got["grads"][k] - want).abs().max())
            scale = float(want.abs().max()) + 1e-12
            if err > 1e-4 * scale + 1e-10:
                raise AssertionError(f"rank {r}: gradient of {k} off by {err}"
                                     f" (scale {scale})")
            report["grad_err"] = max(report["grad_err"], err / scale)
            if not torch.equal(got["stepped"][k],
                               ref["params"][k] - LR * got["grads"][k]):
                raise AssertionError(f"rank {r}: the SGD step on {k}")
        err = float((got["door"] - ref["door"]).abs().max())
        if err > 1e-4:
            raise AssertionError(f"rank {r}: sharded wavefront off by {err}")
        report["door_err"] = max(report["door_err"], err)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    for flag, kind in (("--rank", int), ("--world", int), ("--port", int),
                       ("--target", str), ("--kwargs", str), ("--out", str),
                       ("--backend", str), ("--timeout", float)):
        ap.add_argument(flag, type=kind, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args)
        return 0
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry ok:", tuple(out.shape), float(out.mean()))
    print("dryrun_multichip ok:", dryrun_multichip(args.ranks, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
