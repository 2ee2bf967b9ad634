"""The process group, its (data, model) layout and each rank's share of a
batch (counterpart of ssv_tpu/parallel/mesh.py).

The JAX package lays its devices out as a `(n / M, M)` mesh over the axes
`("data", "model")` and shards every global batch along `data`, replicated
over `model`. The port runs one process a rank, as `torchrun` starts them,
and lays world rank r out as `np.arange(n).reshape(n // M, M)` does: data
rank `r // M`, model rank `r % M`. Each column of that grid (the ranks of
one model rank) is a data group, each row (the ranks of one data rank) a
model group. Each rank trains on its data rank's contiguous slice of every
global batch, so the model ranks of a row hold the same rows; the
collectives of `parallel/per_device.py` reduce over the data group by
default, which is the whole world at M = 1, and make the step equal the
single-process step on the whole batch. Only SwAV's prototype table is
sharded over the model group (`models/heads.py`), as in the JAX dry run;
everything else is replicated on every rank. Without a process group every
function here is the single-process one: world 1, rank 0, the whole batch.
"""

from __future__ import annotations

import contextlib
import os
from datetime import timedelta

import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it raises, so a
# rank that died fails the others instead of leaving them waiting (gloo's
# own default is 30 minutes)
TIMEOUT_S = 300.0


class _Layout:
    """The (data, model) grid of the world: the model-axis size and this
    rank's data and model groups (None at M = 1: the whole world and no
    model group); `alone` makes the process a world of one (`local`)."""

    def __init__(self, model_parallel: int = 1, data_group=None, model_group=None):
        self.model_parallel = model_parallel
        self.data_group = data_group
        self.model_group = model_group
        self.alone = False


_layout = _Layout()


def active() -> bool:
    return dist.is_available() and dist.is_initialized() and not _layout.alone


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def model_size() -> int:
    return _layout.model_parallel if active() else 1


def model_rank() -> int:
    return rank() % model_size()


def data_size() -> int:
    return world_size() // model_size()


def data_rank() -> int:
    return rank() // model_size()


def data_group():
    """This rank's data group (its column of the grid): the group every
    collective of `per_device` reduces over by default; None, the whole
    world, at M = 1."""
    return _layout.data_group if active() else None


def model_group():
    """This rank's model group (its row of the grid), over which SwAV's
    prototype table is sharded; None at M = 1."""
    return _layout.model_group if active() else None


def group_size(group) -> int:
    """The ranks of `group` (None: the world); 1 without a process group."""
    return dist.get_world_size(group) if active() else 1


def group_rank(group) -> int:
    """This rank's place in `group` (None: the world)."""
    return dist.get_rank(group) if active() else 0


def set_model_parallel(model_parallel: int) -> None:
    """Lays the world out as (W / M, M) and builds one data group per
    column and one model group per row; every rank calls it, with the same
    M. Raises unless M divides the world. M = 1 builds no group: the data
    group is the world."""
    global _layout
    w, m = world_size(), int(model_parallel)
    if m < 1 or w % m:
        raise ValueError(f"a model axis of {m} does not divide the world of {w} rank(s)")
    if m == 1:
        _layout = _Layout()
        return
    # every rank creates every group, in the same order, as new_group requires
    columns = [dist.new_group(list(range(c, w, m))) for c in range(m)]
    rows = [dist.new_group(list(range(r * m, (r + 1) * m))) for r in range(w // m)]
    _layout = _Layout(m, columns[rank() % m], rows[rank() // m])


@contextlib.contextmanager
def local():
    """Within it this process is a world of one (no collective runs, the
    whole batch is its own): a one-process reference step beside a group."""
    before = _layout.alone
    _layout.alone = True
    try:
        yield
    finally:
        _layout.alone = before


def launched() -> bool:
    """Whether torchrun's environment names this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init(device: torch.device | str, backend: str | None = None,
         init_method: str = "env://", rank: int | None = None,
         world_size: int | None = None, timeout_s: float = TIMEOUT_S,
         model_parallel: int = 1) -> torch.device:
    """Starts the process group, lays it out as (W / model_parallel,
    model_parallel) (`set_model_parallel`) and returns this rank's device.
    `backend` defaults to NCCL for a CUDA device and gloo for the CPU; gloo
    also carries CUDA tensors (ranks sharing one card, which NCCL refuses).
    A CUDA device given without an index is `cuda:LOCAL_RANK`, and becomes
    the current device."""
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
    set_model_parallel(model_parallel)
    return device


def init_from_env(device: str) -> torch.device | None:
    """Under torchrun, starts the group from its environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and returns
    the rank's device; otherwise starts nothing and returns None."""
    if not launched():
        return None
    return init(device)


def destroy() -> None:
    global _layout
    if active():
        dist.destroy_process_group()
    _layout = _Layout()


def barrier() -> None:
    if active():
        dist.barrier()


def batch_slice(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous B/D rows of a global batch `x` (B, ...), by its
    data rank over the D data ranks, as the JAX package's `P("data")`
    sharding splits it (the model ranks of a row hold the same rows); D
    must divide B."""
    w = data_size()
    if w == 1:
        return x
    b = x.shape[0]
    if b % w:
        raise ValueError(f"a global batch of {b} does not split over {w} data ranks")
    n = b // w
    r = data_rank()
    return x[r * n:(r + 1) * n]


@torch.no_grad()
def broadcast_(tensors) -> None:
    """Overwrites each tensor with rank 0's, in place."""
    if world_size() == 1:
        return
    for t in tensors:
        dist.broadcast(t, 0)


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Gives every rank its data group's first rank's parameters and buffers
    (rank 0's at M = 1), as the JAX trainer puts one state on every replica;
    the model ranks of a row keep their own shards."""
    if data_size() > 1:
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t, model_rank(), group=data_group())
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
