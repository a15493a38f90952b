"""Multi-process bring-up on `torch.distributed`.

Port of space_gym_tpu/parallel/distributed.py.  One process drives one card
(or the CPU); `init_distributed` joins the process group once per process,
before any collective, and `make_mesh` (parallel/mesh.py) then spans its
ranks.  With no cluster in the environment a single process proceeds
undistributed, as the JAX helper does.

    init_distributed()                                   # torchrun, or one process
    init_distributed("10.0.0.1:29500", num_processes=4, process_id=rank)

The backend follows the device: "nccl" for the card, "gloo" for the CPU;
`backend=` overrides it.  A failing init raises; nothing falls back to
another backend.  NCCL takes one rank per card, so two ranks sharing one
card run over gloo, whose collectives also take CUDA tensors.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

_CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> int:
    """Join the process group (idempotent) and return this process's rank.

    With no address it reads torchrun's RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT; where they are absent and `num_processes` is None or 1 it
    proceeds undistributed and returns 0.  `device` (the card by default)
    picks the backend unless `backend` is given."""
    if dist.is_initialized():
        return dist.get_rank()
    if coordinator_address is None:
        if not all(k in os.environ for k in _CLUSTER_ENV):
            if num_processes not in (None, 1):
                raise ValueError(f"num_processes={num_processes} needs a coordinator_address "
                                 "or torchrun's environment")
            if os.environ.get("SGT_DEBUG"):
                print("init_distributed: single-process run, no process group")
            return 0
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator_address needs num_processes and process_id")
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def process_count() -> int:
    """Ranks in the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_lane_slice(total_lanes: int) -> slice:
    """The [start, stop) lane range owned by this process when `total_lanes`
    shard evenly over the processes along the "data" axis."""
    n = process_count()
    if total_lanes % n:
        raise ValueError(f"lanes {total_lanes} not divisible by {n} processes")
    per = total_lanes // n
    i = process_index()
    return slice(i * per, (i + 1) * per)
