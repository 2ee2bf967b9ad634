"""Full-state checkpoints (port of ssv_tpu/train/checkpoint.py).

A checkpoint is one `torch.save` of the whole `TrainState`: the model, the
optimizer (momentum buffers), the scheduler, the step, each module of
`extra` (an EMA target with its BN statistics), and the state of the
generator every random draw of the run comes from (one a rank). Restoring all of it
makes a resumed run equal the run that was never stopped.

Across ranks the state is the same on every rank and each rank draws from
its own generator: every rank's generator state is gathered to the one
file rank 0 writes, and each rank restores its own, so a checkpoint
resumes only at the world size that wrote it.
"""

from __future__ import annotations

import os

import torch

from ..parallel import rank, world_size
from ..parallel.mesh import gather_objects, model_size
from .base import TrainState


def _no_model_axis() -> None:
    """A state sharded over a model axis is not one state rank 0 could
    write (its shard is not the table): the model axis does not
    checkpoint, as the JAX dry run's DPxTP phase does not."""
    if model_size() > 1:
        raise RuntimeError(f"no checkpoint under a model axis of {model_size()}: rank 0 "
                           f"holds one shard of the prototype table, not the table")


def save_state(path: str, state: TrainState, generator: torch.Generator) -> None:
    """Writes the checkpoint to a temporary file and renames it over `path`,
    so an interrupted save leaves the previous checkpoint whole. Every rank
    calls it; rank 0 writes. Raises under a model axis."""
    _no_model_axis()
    generators = gather_objects(generator.get_state())
    if rank() != 0:
        return
    blob = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step,
        "extra": {k: m.state_dict() for k, m in state.extra.items()},
        "generators": generators,
    }
    tmp = f"{path}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def restore_state(path: str, state: TrainState,
                  generator: torch.Generator | None) -> TrainState:
    """Loads a checkpoint into `state` and, unless None, `generator` (this
    rank's), in place, its tensors mapped to the device the model lives on.
    Restoring a generator at another world size than the saving run's
    raises, and so does any restore under a model axis."""
    _no_model_axis()
    device = next(state.model.parameters()).device
    blob = torch.load(path, map_location=device, weights_only=True)
    saved = len(blob["generators"])
    if generator is not None and saved != world_size():
        raise ValueError(f"checkpoint {path} was saved by {saved} rank(s) and holds a "
                         f"generator for each; this run has {world_size()}: resume it "
                         f"at the world size that saved it")
    if set(blob["extra"]) != set(state.extra):
        raise KeyError(f"checkpoint {path} holds extra {sorted(blob['extra'])}, "
                       f"the algorithm {sorted(state.extra)}")
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.scheduler.load_state_dict(blob["scheduler"])
    state.step = int(blob["step"])
    for k, module in state.extra.items():
        module.load_state_dict(blob["extra"][k])
    if generator is not None:
        generator.set_state(blob["generators"][rank()].cpu())
    return state
