"""SwAV (port of ssv_tpu/train/algorithms/swav.py): encoder and a
fc-bn-gelu-fc-bn projector (L2-normalized), a table of trainable
L2-normalized prototypes, Sinkhorn-Knopp codes and the swapped-prediction
loss, with a ring bank of past embeddings concatenated to each view to
fatten the assignment problem.

  * the model holds the tower and the prototypes, so one SGD steps both, as
    the JAX package's single `params` tree is stepped;
  * `pre_train` fills the bank with the last `feature_bank_size` rows of
    the train split's features, in order;
  * each step pushes both views' embeddings, detached, after the update.

Under a model axis (`parallel/mesh.py`, M > 1: the dry run, not the CLI)
each rank holds its model rank's K/M rows of the table (`Prototypes`), the
views' embeddings are gathered over the data group, and the loss is
column-parallel across the model group (`objectives/losses.py`). Each
gradient is then meaned over the ranks that hold its parameter: the
shard's over its data group, the tower's over the world. The model ranks
of a row compute the same tower gradient, so the world's mean is the data
group's, but only a collective makes their copies equal bit for bit where
the card's kernels (cuDNN's weight gradients) do not sum in a fixed order.
The bank, pushed from the gathered rows, is the same on every rank. At
M = 1 the step is the data-parallel one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ...models.heads import Prototypes, swav_projection
from ...models.registry import build_encoder
from ...objectives.losses import swav_loss
from ...parallel import mesh, pgather, reduce_grads
from ...state.banks import RingBuffer, ring_push
from ..base import Algorithm, DataInfo, TrainState
from .common import Tower, forward_views


class SwAVModel(nn.Module):
    """The tower and the prototypes, trained together."""

    def __init__(self, tower: Tower, prototypes: Prototypes):
        super().__init__()
        self.tower = tower
        self.prototypes = prototypes

    def forward(self, x):
        return self.tower(x)

    def init_weights(self, generator: torch.Generator):
        self.tower.init_weights(generator)
        self.prototypes.init_weights(generator)


class SwAV(Algorithm):
    name = "swav"
    batch_kind = "double"

    def __init__(self, config, arch: str, data: DataInfo, device: torch.device):
        super().__init__(config, arch, data, device)
        self.proj_dim = int(config["proj_dim"])
        encoder, dim = build_encoder(arch, self.encoder_cfg())
        tower = Tower(encoder, swav_projection(dim, int(config["hidden_dim"]), self.proj_dim))
        self.model = SwAVModel(tower, Prototypes(int(config["prototype_size"]), self.proj_dim,
                                                 mesh.model_size(), mesh.model_rank()))
        self.bank_size = int(config["feature_bank_size"])
        self.loss_cfg = dict(config.get("loss_fn", {}) or {})
        self.fuse = bool(config.get("fuse_views", False))

    def init_state(self, generator: torch.Generator) -> TrainState:
        model = self.place(self.model, generator)
        bank = RingBuffer(self.bank_size, self.proj_dim).to(self.device)
        optimizer, scheduler = self.make_optimizer(model)
        return TrainState(model, optimizer, scheduler, 0, {"bank": bank})

    def pre_train(self, state: TrainState, trainer) -> TrainState:
        fvecs, _ = trainer.features_for(state, "train")
        ring_push(state.extra["bank"], fvecs[-self.bank_size:])
        return state

    def train_step(self, state: TrainState, batch: dict, generator=None):
        bank = state.extra["bank"]
        state.model.train()
        with self.autocast():
            z1, z2 = forward_views(state.model.tower, [batch["aug_1"], batch["aug_2"]],
                                   self.fuse)
        # Sinkhorn's marginals and the bank push span the global batch
        z1, z2 = pgather(z1.float()), pgather(z2.float())
        loss = swav_loss(z1, z2, state.model.prototypes(), bank_features=bank.data,
                         group=mesh.model_group(), **self.loss_cfg)
        state, loss = self.grad_step(state, loss, loss_scope="global")
        ring_push(bank, torch.cat([z1, z2]).detach())
        return state, {"loss": loss}

    def reduce_gradients(self, state: TrainState, loss_scope: str) -> None:
        if mesh.model_size() == 1:
            return super().reduce_gradients(state, loss_scope)
        reduce_grads(state.model.tower.parameters(), loss_scope, group=dist.group.WORLD)
        reduce_grads(state.model.prototypes.parameters(), loss_scope)

    @torch.no_grad()
    def embed(self, state: TrainState, images):
        """The tower's output, L2-normalized by its head."""
        state.model.eval()
        with self.autocast():
            return state.model(images).float()
