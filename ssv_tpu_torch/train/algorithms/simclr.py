"""SimCLR (reference models/simclr.py): shared encoder + 2-layer BN
projection head over two augmented views, NT-Xent loss."""

from __future__ import annotations

import torch

from ...models.heads import simclr_projection
from ...models.registry import build_encoder
from ...objectives.losses import l2_normalize, nt_xent
from ...parallel import pgather
from ...utils import trace
from ..base import Algorithm, DataInfo, TrainState
from .common import Tower, forward_views


class SimCLR(Algorithm):
    name = "simclr"
    batch_kind = "double"

    def __init__(self, config, arch: str, data: DataInfo, device: torch.device):
        super().__init__(config, arch, data, device)
        encoder, dim = build_encoder(arch, self.encoder_cfg())
        self.model = Tower(encoder, simclr_projection(dim, int(config["proj_dim"])))
        self.loss_cfg = dict(config.get("loss_fn", {}) or {})
        # fuse_views (common.forward_views): one forward of the 2N batch, or
        # the reference's two sequential forwards (the default)
        self.fuse = bool(config.get("fuse_views", False))

    def init_state(self, generator: torch.Generator) -> TrainState:
        model = self.place(self.model, generator)
        optimizer, scheduler = self.make_optimizer(model)
        return TrainState(model, optimizer, scheduler, 0)

    def train_step(self, state: TrainState, batch: dict, generator=None):
        model = state.model
        model.train()
        with self.autocast():
            z1, z2 = forward_views(model, [batch["aug_1"], batch["aug_2"]], self.fuse)
        # the negatives span the global batch
        trace.phase("loss")
        loss = nt_xent(pgather(z1.float()), pgather(z2.float()), **self.loss_cfg)
        state, loss = self.grad_step(state, loss, loss_scope="global")
        return state, {"loss": loss}

    @torch.no_grad()
    def embed(self, state: TrainState, images):
        state.model.eval()
        with self.autocast():
            z = state.model(images)
        return l2_normalize(z.float())
