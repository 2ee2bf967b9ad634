"""SimCLR (reference models/simclr.py): shared encoder + 2-layer BN
projection head over two augmented views, NT-Xent loss."""

from __future__ import annotations

import torch

from ...models.heads import simclr_projection
from ...models.registry import build_encoder
from ...objectives.losses import l2_normalize, nt_xent
from ..base import Algorithm, DataInfo, TrainState
from .common import Tower


class SimCLR(Algorithm):
    name = "simclr"
    batch_kind = "double"

    def __init__(self, config, arch: str, data: DataInfo, device: torch.device):
        super().__init__(config, arch, data, device)
        encoder, dim = build_encoder(arch, dict(config.get("encoder") or {}))
        self.model = Tower(encoder, simclr_projection(dim, int(config["proj_dim"])))
        self.loss_cfg = dict(config.get("loss_fn", {}) or {})
        # fuse_views=true runs both views through ONE forward of a 2N batch,
        # so BN sees the union batch; the default runs the reference's two
        # sequential forwards, updating the BN running stats once per view.
        self.fuse = bool(config.get("fuse_views", False))

    def init_state(self, generator: torch.Generator) -> TrainState:
        """`generator` lives on the host: the weights are drawn there and
        moved, so a run starts from the same weights on any device."""
        self.model.init_weights(generator)
        model = self.model.to(self.device)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        optimizer, scheduler = self.make_optimizer(model)
        return TrainState(model, optimizer, scheduler, 0)

    def train_step(self, state: TrainState, batch: dict, generator=None):
        model = state.model
        model.train()
        with self.autocast():
            if self.fuse:
                z1, z2 = model(torch.cat([batch["aug_1"], batch["aug_2"]])).chunk(2)
            else:
                z1 = model(batch["aug_1"])
                z2 = model(batch["aug_2"])
        loss = nt_xent(z1.float(), z2.float(), **self.loss_cfg)
        state = self.grad_step(state, loss)
        return state, {"loss": loss.detach()}

    @torch.no_grad()
    def embed(self, state: TrainState, images):
        state.model.eval()
        with self.autocast():
            z = state.model(images)
        return l2_normalize(z.float())
