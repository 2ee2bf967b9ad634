"""ReLIC (port of ssv_tpu/train/algorithms/relic.py): BYOL's online and EMA
target towers; NT-Xent between each online view and the target of the other
view, plus a KL invariance term anchored on the online features of the
un-augmented image (the `double` batch's test view `img`)."""

from __future__ import annotations

import torch

from ...objectives.losses import relic_loss
from ...parallel import pgather
from ..base import TrainState
from .byol import BYOL
from .common import forward_views


class ReLIC(BYOL):
    name = "relic"
    batch_kind = "double"

    def __init__(self, config, arch, data, device):
        super().__init__(config, arch, data, device)
        self.loss_cfg = dict(config.get("loss_fn", {}) or {})

    def train_step(self, state: TrainState, batch: dict, generator=None):
        # fuse_views: the target's two forwards become one of 2N images, the
        # online tower's three (aug_1, aug_2, img) one of 3N
        t1, t2 = self.target_views(state, [batch["aug_1"], batch["aug_2"]])
        state.model.train()
        with self.autocast():
            o1, o2, orig = forward_views(
                state.model, [batch["aug_1"], batch["aug_2"], batch["img"]], self.fuse)
        # the NT-Xent terms' negatives span the global batch
        t1, t2 = pgather(t1), pgather(t2)
        o1, o2, orig = pgather(o1.float()), pgather(o2.float()), pgather(orig.float())
        loss = (relic_loss(o1, t2, orig, **self.loss_cfg)
                + relic_loss(o2, t1, orig, **self.loss_cfg))
        tau = state.scheduler.at("tau")
        state, loss = self.grad_step(state, loss, loss_scope="global")
        self.ema(state, tau)
        return state, {"loss": loss}
