"""Full-state checkpoints (port of ssv_tpu/train/checkpoint.py).

A checkpoint is one `torch.save` of the whole `TrainState`: the model, the
optimizer (momentum buffers), the scheduler, the step, each module of
`extra` (an EMA target with its BN statistics), and the state of the
generator every random draw of the run comes from. Restoring all of it
makes a resumed run equal the run that was never stopped.
"""

from __future__ import annotations

import os

import torch

from .base import TrainState


def save_state(path: str, state: TrainState, generator: torch.Generator) -> None:
    """Writes the checkpoint to a temporary file and renames it over `path`,
    so an interrupted save leaves the previous checkpoint whole."""
    blob = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step,
        "extra": {k: m.state_dict() for k, m in state.extra.items()},
        "generator": generator.get_state(),
    }
    tmp = f"{path}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def restore_state(path: str, state: TrainState, generator: torch.Generator) -> TrainState:
    """Loads a checkpoint into `state` and `generator` in place, its tensors
    mapped to the device the model lives on."""
    device = next(state.model.parameters()).device
    blob = torch.load(path, map_location=device, weights_only=True)
    if set(blob["extra"]) != set(state.extra):
        raise KeyError(f"checkpoint {path} holds extra {sorted(blob['extra'])}, "
                       f"the algorithm {sorted(state.extra)}")
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.scheduler.load_state_dict(blob["scheduler"])
    state.step = int(blob["step"])
    for k, module in state.extra.items():
        module.load_state_dict(blob["extra"][k])
    generator.set_state(blob["generator"].cpu())
    return state
