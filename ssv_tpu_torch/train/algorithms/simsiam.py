"""SimSiam (port of ssv_tpu/train/algorithms/simsiam.py): a 3-layer
projector and a bottleneck predictor, symmetric negative cosine.

`target_mode`:
  * "stopgrad" (default, the paper): the target of a view is the online
    projector's output for the other view, detached. One forward per view
    gives both, through `Tower(..., return_pair=True)`;
  * "frozen" (the reference's behavior): a separately initialized target
    tower that no step updates; its forward runs in train mode under
    `no_grad`, so only its BN running statistics advance.
"""

from __future__ import annotations

import torch

from ...models.heads import simsiam_predictor, simsiam_projector
from ...models.registry import build_encoder
from ...objectives.losses import simsiam_neg_cosine
from ..base import Algorithm, DataInfo, TrainState
from .common import Tower, forward_views

TARGET_MODES = ("stopgrad", "frozen")


class SimSiam(Algorithm):
    name = "simsiam"
    batch_kind = "double"

    def __init__(self, config, arch: str, data: DataInfo, device: torch.device):
        super().__init__(config, arch, data, device)
        proj_dim = int(config["proj_dim"])
        bottleneck = int(config.get("bottleneck_dim", 128))
        self.mode = str(config.get("target_mode", "stopgrad"))
        if self.mode not in TARGET_MODES:
            raise ValueError(f"target_mode must be one of {TARGET_MODES}, got {self.mode!r}")
        encoder_cfg = self.encoder_cfg()
        encoder, dim = build_encoder(arch, encoder_cfg)
        self.online = Tower(encoder, simsiam_projector(dim, proj_dim),
                            pred=simsiam_predictor(proj_dim, bottleneck), norm_out=True)
        if self.mode == "frozen":
            encoder_t, _ = build_encoder(arch, encoder_cfg)
            self.target = Tower(encoder_t, simsiam_projector(dim, proj_dim), norm_out=True)
        self.fuse = bool(config.get("fuse_views", False))

    def init_state(self, generator: torch.Generator) -> TrainState:
        online = self.place(self.online, generator)
        extra = {}
        if self.mode == "frozen":
            extra["target"] = self.place(self.target, generator).requires_grad_(False)
        optimizer, scheduler = self.make_optimizer(online)
        return TrainState(online, optimizer, scheduler, 0, extra)

    def train_step(self, state: TrainState, batch: dict, generator=None):
        views = [batch["aug_1"], batch["aug_2"]]
        model = state.model.train()
        if self.mode == "frozen":
            target = state.extra["target"].train()
            with torch.no_grad(), self.autocast():
                z1, z2 = forward_views(target, views, self.fuse)
            with self.autocast():
                o1, o2 = forward_views(model, views, self.fuse)
        else:
            with self.autocast():
                if self.fuse:
                    z, o = model(torch.cat(views), return_pair=True)
                    (z1, z2), (o1, o2) = z.chunk(2), o.chunk(2)
                else:
                    z1, o1 = model(views[0], return_pair=True)
                    z2, o2 = model(views[1], return_pair=True)
        o1, o2, z1, z2 = o1.float(), o2.float(), z1.float(), z2.float()
        loss = 0.5 * (simsiam_neg_cosine(o1, z2) + simsiam_neg_cosine(o2, z1))
        state, loss = self.grad_step(state, loss)
        return state, {"loss": loss}

    @torch.no_grad()
    def embed(self, state: TrainState, images):
        state.model.eval()
        with self.autocast():
            return state.model(images).float()

    @torch.no_grad()
    def embed_backbone(self, state: TrainState, images):
        """The online encoder's features, before the projector."""
        state.model.eval()
        with self.autocast():
            return state.model.encoder(images).float()
