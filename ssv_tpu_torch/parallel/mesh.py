"""The process group and each rank's share of a batch (counterpart of
ssv_tpu/parallel/mesh.py).

The JAX package lays its devices out as a 1-D `data` mesh and shards every
global batch along it, with the parameters replicated. The port runs one
process a rank, as `torchrun` starts them: each rank holds a replica of
the state, trains on its contiguous slice of every global batch, and the
collectives of `parallel/per_device.py` make the step equal the
single-process step on the whole batch. Without a process group every
function here is the single-process one: world 1, rank 0, the whole batch.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it raises, so a
# rank that died fails the others instead of leaving them waiting (gloo's
# own default is 30 minutes)
TIMEOUT_S = 300.0


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def launched() -> bool:
    """Whether torchrun's environment names this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init(device: torch.device | str, backend: str | None = None,
         init_method: str = "env://", rank: int | None = None,
         world_size: int | None = None, timeout_s: float = TIMEOUT_S) -> torch.device:
    """Starts the process group and returns this rank's device. `backend`
    defaults to NCCL for a CUDA device and gloo for the CPU; gloo also
    carries CUDA tensors (two ranks on one card, which NCCL refuses). A CUDA
    device given without an index is `cuda:LOCAL_RANK`, and becomes the
    current device."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if rank is not None:
        kwargs.update(rank=rank, world_size=world_size)
    dist.init_process_group(backend, init_method=init_method,
                            timeout=timedelta(seconds=timeout_s), **kwargs)
    return device


def init_from_env(device: str) -> torch.device | None:
    """Under torchrun, starts the group from its environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and returns
    the rank's device; otherwise starts nothing and returns None."""
    if not launched():
        return None
    return init(device)


def destroy() -> None:
    if active():
        dist.destroy_process_group()


def barrier() -> None:
    if active():
        dist.barrier()


def batch_slice(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous B/W rows of a global batch `x` (B, ...), as the
    JAX package's `P("data")` sharding splits it; W must divide B."""
    w = world_size()
    if w == 1:
        return x
    b = x.shape[0]
    if b % w:
        raise ValueError(f"a global batch of {b} does not split over {w} ranks")
    n = b // w
    r = rank()
    return x[r * n:(r + 1) * n]


@torch.no_grad()
def broadcast_(tensors) -> None:
    """Overwrites each tensor with rank 0's, in place."""
    if world_size() == 1:
        return
    for t in tensors:
        dist.broadcast(t, 0)


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Gives every rank rank 0's parameters and buffers, as the JAX trainer
    puts one state on every replica."""
    broadcast_([*module.parameters(), *module.buffers()])
    return module


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (a picklable value)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]


def gather_objects(obj) -> list:
    """Every rank's `obj`, in rank order, on every rank."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out
