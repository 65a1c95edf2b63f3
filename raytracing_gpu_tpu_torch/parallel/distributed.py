"""Joining a process group (counterpart of
`raytracing_gpu_tpu/parallel/distributed.py`).

`initialize` calls `torch.distributed.init_process_group` with a TCP
rendezvous at the coordinator's address, from explicit arguments (the
CLI's `--coordinator-address`, `--num-processes`, `--process-id`) or from
torchrun's environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`,
`MASTER_PORT`).  Then `parallel.mesh.make_mesh` lays the world's ranks out
as an (sp, dp) mesh; the scene is replicated, and the ranks exchange only
the sp sums, the dp spans and, in training, the parameter gradients.

The backend is chosen and logged: gloo on the CPU; NCCL when each rank
of a host has a card of its own; gloo when ranks share a card, which
NCCL refuses.  A rank that cannot join raises, after `timeout` seconds
at most; so does a collective that waits longer.  With the chunk
checkpoint (`utils/checkpoint.py`) a restarted job resumes from the last
chunk saved.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger("raytracing_gpu_tpu_torch")

TIMEOUT_S = 60.0   # a missing peer fails the rendezvous within this


def choose_backend(device: torch.device | str, local_ranks: int) -> str:
    """gloo for the CPU; NCCL when the host's `local_ranks` ranks each have
    a card of their own; gloo when they share cards (NCCL refuses two
    ranks on one device)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: torch.device | str = "cuda",
               timeout: float = TIMEOUT_S) -> None:
    """Join the process group of `num_processes` ranks as rank
    `process_id`, with its rendezvous at `coordinator_address` (host:port).

    With no arguments it reads torchrun's environment; with
    `num_processes` <= 1, or nothing set, it logs and stays single-process
    (`distributed.py:36-38`).  `backend` defaults to `choose_backend` for
    `device` and the host's ranks (torchrun's `LOCAL_WORLD_SIZE`, else all
    of them).  Raises when the rendezvous or the group fails."""
    env = os.environ
    if num_processes is not None and num_processes <= 1:
        logger.info("single process; no process group")
        return
    if coordinator_address is None:
        if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                      "MASTER_PORT")):
            logger.info("no distributed environment detected; single "
                        "process")
            return
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
        if num_processes <= 1:
            logger.info("single process; no process group")
            return
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator-address needs --num-processes and "
                         "--process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a world of "
                         f"{num_processes}")
    if backend is None:
        local = int(env.get("LOCAL_WORLD_SIZE", num_processes))
        backend = choose_backend(device, local)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))
    logger.info("distributed: rank %d of %d, backend %s, coordinator %s",
                dist.get_rank(), dist.get_world_size(), backend,
                coordinator_address)


def finalize() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_coordinator() -> bool:
    """True on rank 0, the rank that writes the image, the checkpoints and
    the progress lines (every rank renders its share)."""
    return _world()[0] == 0


def local_chunk_slice(total: int) -> slice:
    """The [start, stop) range of a length-`total` work axis that this rank
    owns when the work is split evenly over the world
    (`distributed.py:62-67`)."""
    i, n = _world()
    per = (total + n - 1) // n
    return slice(i * per, min((i + 1) * per, total))


def rank_device(device: torch.device | str) -> torch.device:
    """This rank's device: a bare "cuda" becomes
    `cuda:{LOCAL_RANK % device_count}` (torchrun's local rank, else the
    global rank); "cpu" and an indexed device stay as they are."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", _world()[0]))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))
