"""MoCo (port of ssv_tpu/train/algorithms/moco.py): a query tower (encoder,
ReLU-Linear head) and a key tower that is its EMA, InfoNCE of each query
against its key and a ring queue of past keys.

  * the key tower starts as an exact copy of the query tower and lives in
    `state.extra["target"]`; the queue, a `RingBuffer` of zeros, in
    `state.extra["queue"]`;
  * the key forward (of `aug_2`) runs in train mode under `no_grad`: its
    BatchNorm uses batch statistics and advances its own running
    statistics, as the flax key's `batch_stats` do;
  * the loss is taken against the queue as it was before this step's push;
  * after the optimizer step the key tower moves toward the *updated*
    query weights at momentum m, and the L2-normalized keys are pushed.
"""

from __future__ import annotations

import copy

import torch

from ...models.heads import LinearHead
from ...models.registry import build_encoder
from ...objectives.losses import l2_normalize, moco_nce
from ...parallel import pgather
from ...state.banks import RingBuffer, ring_push
from ...state.ema import ema_update
from ..base import Algorithm, DataInfo, TrainState
from .common import Tower


class MoCo(Algorithm):
    name = "moco"
    batch_kind = "double"

    def __init__(self, config, arch: str, data: DataInfo, device: torch.device):
        super().__init__(config, arch, data, device)
        self.proj_dim = int(config["proj_dim"])
        encoder, dim = build_encoder(arch, self.encoder_cfg())
        self.model = Tower(encoder, LinearHead(dim, self.proj_dim))
        self.queue_size = int(config["queue_size"])
        self.m = float(config.get("momentum", 0.999))
        self.loss_cfg = dict(config.get("loss_fn", {}) or {})

    def init_state(self, generator: torch.Generator) -> TrainState:
        model = self.place(self.model, generator)
        key = copy.deepcopy(model).requires_grad_(False)
        queue = RingBuffer(self.queue_size, self.proj_dim).to(self.device)
        optimizer, scheduler = self.make_optimizer(model)
        return TrainState(model, optimizer, scheduler, 0, {"target": key, "queue": queue})

    def train_step(self, state: TrainState, batch: dict, generator=None):
        key, queue = state.extra["target"].train(), state.extra["queue"]
        with torch.no_grad(), self.autocast():
            k = key(batch["aug_2"]).float()
        state.model.train()
        with self.autocast():
            q = state.model(batch["aug_1"]).float()
        loss = moco_nce(q, k, queue.data, **self.loss_cfg)
        state, loss = self.grad_step(state, loss)
        ema_update(key.parameters(), state.model.parameters(), self.m)
        # the queue advances by the global batch's keys, the same on every rank
        ring_push(queue, l2_normalize(pgather(k)))
        return state, {"loss": loss}

    @torch.no_grad()
    def embed(self, state: TrainState, images):
        state.model.eval()
        with self.autocast():
            z = state.model(images)
        return l2_normalize(z.float())
