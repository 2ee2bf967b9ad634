"""Trainer-side abstractions (port of ssv_tpu/train/base.py).

One generic trainer (train/trainer.py) drives small algorithm objects:

    init_state(generator)                  -> TrainState
    train_step(state, batch, generator)    -> (TrainState, metrics)
    embed(state, images)                   -> features

plus optional hooks (`post_epoch`, `pre_train`, `pre_epoch`). The
`TrainState` holds the model, its optimizer and scheduler, and the global
step; `grad_step` is the shared backward + optimizer update.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


@dataclass
class DataInfo:
    num_classes: int
    n_train: int
    batch_size: int
    steps_per_epoch: int


class Algorithm:
    """Base class; subclasses live in train/algorithms/."""

    name: str = "base"
    batch_kind: str = "double"

    def __init__(self, config, arch: str, data: DataInfo, device: torch.device):
        self.config = config
        self.data = data
        self.device = torch.device(device)
        self.epochs = int(config["epochs"])
        # `compute_dtype: float32` runs every encoder/head layer in float32;
        # the default is bf16 autocast with float32 params and BN statistics.
        compute = config.get("compute_dtype")
        if compute not in (None, "float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute!r}")
        self.autocast_dtype = None if compute == "float32" else torch.bfloat16

    def autocast(self):
        """The mixed-precision region for model forwards."""
        if self.autocast_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.autocast_dtype)

    # -- required -----------------------------------------------------
    def init_state(self, generator: torch.Generator) -> TrainState:
        raise NotImplementedError

    def train_step(self, state: TrainState, batch: dict, generator: torch.Generator):
        """One optimizer step; returns (state, metrics of device tensors)."""
        raise NotImplementedError

    def embed(self, state: TrainState, images):
        """Features for KNN validation, per-algorithm semantics of the
        reference's build_features."""
        raise NotImplementedError

    # -- optional hooks ------------------------------------------------
    def post_epoch(self, state: TrainState, epoch: int) -> TrainState:
        return state

    def pre_train(self, state: TrainState, trainer) -> TrainState:
        return state

    def pre_epoch(self, state: TrainState, trainer, epoch: int) -> TrainState:
        return state

    # -- shared helpers -------------------------------------------------
    def lr_fn(self) -> Callable[[int], float]:
        from ..utils.schedules import lr_schedule
        return lr_schedule(dict(self.config["optimizer"]),
                           dict(self.config.get("scheduler", {}) or {}),
                           epochs=self.epochs,
                           steps_per_epoch=self.data.steps_per_epoch)

    def make_optimizer(self, model: torch.nn.Module):
        from .optim import get_optimizer
        return get_optimizer(dict(self.config["optimizer"]), model.parameters(),
                             self.lr_fn())

    def grad_step(self, state: TrainState, loss: torch.Tensor) -> TrainState:
        """Backward of `loss`, one optimizer step at lr(state.step), then the
        schedule advances to the next step."""
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state
