"""BYOL (port of ssv_tpu/train/algorithms/byol.py): an online tower
(encoder, projector, predictor) against an EMA target tower (encoder,
projector), symmetric MSE on L2-normalized outputs.

  * the target is initialized separately, not copied from the online tower,
    and lives in `state.extra["target"]`;
  * its forward runs in train mode under `no_grad`: its BatchNorm uses batch
    statistics and advances its own running statistics, as the flax target's
    `batch_stats` do;
  * tau follows the cosine ramp tau_lower -> tau_upper over the global step,
    taken at the step before the update (a step table, read at the device
    counter); the EMA runs after the optimizer step, over the online encoder
    and projector (not the predictor).
"""

from __future__ import annotations

import torch

from ...models.heads import byol_mlp
from ...models.registry import build_encoder
from ...objectives.losses import byol_mse
from ...state.ema import ema_update
from ...utils.schedules import cosine_ramp
from ..base import Algorithm, DataInfo, TrainState
from .common import Tower, forward_views


class BYOL(Algorithm):
    name = "byol"
    batch_kind = "double"

    def __init__(self, config, arch: str, data: DataInfo, device: torch.device):
        super().__init__(config, arch, data, device)
        proj_dim = int(config["proj_dim"])
        encoder_cfg = self.encoder_cfg()
        encoder, dim = build_encoder(arch, encoder_cfg)
        encoder_t, _ = build_encoder(arch, encoder_cfg)
        self.online = Tower(encoder, byol_mlp(dim, proj_dim),
                            pred=byol_mlp(proj_dim, proj_dim), norm_out=True)
        self.target = Tower(encoder_t, byol_mlp(dim, proj_dim), norm_out=True)
        self.tau_lower = float(config.get("tau_lower", config.get("tau", 0.996)))
        self.tau_upper = float(config.get("tau_upper", 1.0))
        self.fuse = bool(config.get("fuse_views", False))

    def init_state(self, generator: torch.Generator) -> TrainState:
        online = self.place(self.online, generator)
        target = self.place(self.target, generator).requires_grad_(False)
        optimizer, scheduler = self.make_optimizer(online)
        return TrainState(online, optimizer, scheduler, 0, {"target": target})

    def tau(self, step: int) -> float:
        return cosine_ramp(step, self.total_steps, self.tau_lower, self.tau_upper)

    def step_tables(self):
        return {"tau": self.tau}

    def target_views(self, state: TrainState, views: list) -> list:
        """The target's outputs, float32, without a graph; its BN runs in
        train mode and advances its running statistics."""
        target = state.extra["target"].train()
        with torch.no_grad(), self.autocast():
            return [t.float() for t in forward_views(target, views, self.fuse)]

    def ema(self, state: TrainState, tau) -> None:
        online, target = state.model, state.extra["target"]
        ema_update([*target.encoder.parameters(), *target.proj.parameters()],
                   [*online.encoder.parameters(), *online.proj.parameters()], tau)

    def train_step(self, state: TrainState, batch: dict, generator=None):
        views = [batch["aug_1"], batch["aug_2"]]
        t1, t2 = self.target_views(state, views)
        state.model.train()
        with self.autocast():
            o1, o2 = forward_views(state.model, views, self.fuse)
        loss = byol_mse(o1.float(), o2.float(), t1, t2)
        tau = state.scheduler.at("tau")
        state, loss = self.grad_step(state, loss)
        self.ema(state, tau)
        return state, {"loss": loss, "tau": tau}

    @torch.no_grad()
    def embed(self, state: TrainState, images):
        """The whole online tower, predictor included (reference byol.py
        build_features)."""
        state.model.eval()
        with self.autocast():
            return state.model(images).float()

    @torch.no_grad()
    def embed_backbone(self, state: TrainState, images):
        """The online encoder's features, before the projector."""
        state.model.eval()
        with self.autocast():
            return state.model.encoder(images).float()
