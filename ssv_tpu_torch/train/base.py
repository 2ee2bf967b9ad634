"""Trainer-side abstractions (port of ssv_tpu/train/base.py).

One generic trainer (train/trainer.py) drives small algorithm objects:

    init_state(generator)                  -> TrainState
    train_step(state, batch, generator)    -> (TrainState, metrics)
    embed(state, images)                   -> features

plus optional hooks (`post_epoch`, `pre_train`, `pre_epoch`). The
`TrainState` holds the model, its optimizer and scheduler, the global step,
and in `extra` the algorithm's other modules (an EMA target), so a
checkpoint is one save; `grad_step` is the shared backward + optimizer
update.

A step reads nothing on the host, so the trainer can capture it as a CUDA
graph and replay it: its per-step numbers (the learning rate, BYOL's tau,
DINO's teacher temperature) are the scheduler's tables read at the device
step counter (`train/optim.py`, `Algorithm.step_tables`), and every state
update is in place. `state.step` is the host's count of the same steps.

Across ranks (`parallel/`) each rank steps its replica on its slice of the
global batch: `place` switches the BatchNorms to global statistics unless
the config asks for `per_device_bn`, and `grad_step` averages the
gradients over the ranks before the update (and, under `per_device_bn`,
the BN running statistics after it), as the JAX `grad_step` reduces them
under `shard_map`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable

import torch

from ..parallel import pmean, pmean_bn_, reduce_grads, sync_batchnorm
from ..parallel.mesh import data_size
from .optim import StepSchedule, get_optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: StepSchedule
    step: int = 0
    extra: dict[str, torch.nn.Module] = field(default_factory=dict)

    @property
    def counter(self) -> torch.Tensor:
        """The steps taken, an int64 on the device (the scheduler's)."""
        return self.scheduler.counter


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
        self.total_steps = self.epochs * data.steps_per_epoch
        # `compute_dtype: float32` runs every encoder/head layer in float32;
        # the default is bf16 autocast with float32 params and BN statistics.
        compute = config.get("compute_dtype")
        if compute not in (None, "float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute!r}")
        self.autocast_dtype = None if compute == "float32" else torch.bfloat16
        # per_device_bn: each rank's BatchNorms see only its slice (the JAX
        # package's shard_map path); otherwise their statistics are global
        self.per_device_bn = bool(config.get("per_device_bn", False))

    def encoder_cfg(self) -> dict:
        """The `encoder` block with `compute_dtype` folded in as its `dtype`
        where it sets none: an explicit encoder `dtype` overrides the
        algorithm's autocast inside the encoder, and the heads keep it."""
        cfg = dict(self.config.get("encoder") or {})
        if self.config.get("compute_dtype"):
            cfg.setdefault("dtype", self.config["compute_dtype"])
        return cfg

    def autocast(self):
        """The mixed-precision region for model forwards. It keeps no
        weight-cast cache: a cache made while the trainer captures the step
        as a CUDA graph would outlive the capture, and without one the eager
        and the captured step launch the same ops."""
        if self.autocast_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.autocast_dtype,
                              cache_enabled=False)

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

    def embed_backbone(self, state: TrainState, images):
        """Raw encoder features (before any head), or None where the
        algorithm has no separate backbone: tells representation collapse
        (backbone dead) from head collapse."""
        return None

    # -- optional hooks ------------------------------------------------
    def post_epoch(self, state: TrainState, epoch: int) -> TrainState:
        return state

    def pre_train(self, state: TrainState, trainer) -> TrainState:
        return state

    def pre_epoch(self, state: TrainState, trainer, epoch: int) -> TrainState:
        return state

    # -- shared helpers -------------------------------------------------
    def place(self, module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
        """Draws `module`'s weights from the host `generator`, so a run
        starts from the same weights on any device (and on every rank), and
        moves it to the device (channels-last for cuDNN on CUDA). Across
        data ranks its BatchNorms take global statistics unless
        `per_device_bn`."""
        module.init_weights(generator)
        if data_size() > 1 and not self.per_device_bn:
            sync_batchnorm(module)
        module = module.to(self.device)
        if self.device.type == "cuda":
            module = module.to(memory_format=torch.channels_last)
        return module

    def lr_fn(self) -> Callable[[int], float]:
        from ..utils.schedules import lr_schedule
        return lr_schedule(dict(self.config["optimizer"]),
                           dict(self.config.get("scheduler", {}) or {}),
                           epochs=self.epochs,
                           steps_per_epoch=self.data.steps_per_epoch)

    def step_tables(self) -> dict[str, Callable[[int], float]]:
        """The algorithm's own per-step numbers as functions of the global
        step (BYOL's tau, DINO's teacher temperature), by name: the
        scheduler tables them beside the learning rate, and a step reads
        them at the device counter with `state.scheduler.at(name)`."""
        return {}

    def make_optimizer(self, model: torch.nn.Module, weight_decay_fn=None, grad_clip=None):
        return get_optimizer(dict(self.config["optimizer"]), model.parameters(),
                             self.lr_fn(), weight_decay_fn=weight_decay_fn,
                             grad_clip=grad_clip, steps=self.total_steps + 1,
                             tables=self.step_tables())

    def reduce_gradients(self, state: TrainState, loss_scope: str) -> None:
        """Means each gradient over the ranks that hold its parameter: the
        data group, for a model replicated on every rank of it."""
        reduce_grads(state.model.parameters(), loss_scope)

    def grad_step(self, state: TrainState, loss: torch.Tensor, update_mask=None,
                  loss_scope: str = "local") -> tuple[TrainState, torch.Tensor]:
        """Backward of `loss`, the gradients averaged over the ranks, one
        optimizer step at lr(state.step), then the schedule advances to the
        next step. Returns the state and the loss's replica mean, detached.
        `loss_scope` says how the loss was built: "local", a per-sample
        mean over this rank's slice, or "global", one loss from gathered
        rows (`parallel/per_device.py` derives why both take the mean).
        `update_mask`, a pair (params, on) with `on` a 0-dim bool on the
        device: where `on` holds, the params keep their values through the
        step, chosen on the device. Their optimizer *update* is zeroed, so
        decoupled weight decay does not move them either, while the
        optimizer's moments take their gradients as usual (the JAX
        package's `update_mask`). Under `per_device_bn` the BN running
        statistics of the state's modules are replica-meaned after the step.
        The gradients are set to None before the backward, which allocates
        them anew (inside a captured step, from the graph's pool: they stay
        the graph's until it is dropped)."""
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.reduce_gradients(state, loss_scope)
        masked, on = update_mask or ((), None)
        frozen = [p.detach().clone() for p in masked]
        state.optimizer.step()
        with torch.no_grad():
            for p, old in zip(masked, frozen):
                p.copy_(torch.where(on, old, p))
        state.scheduler.step()
        state.step += 1
        if self.per_device_bn:
            pmean_bn_(state.model, *state.extra.values())
        return state, pmean(loss)
