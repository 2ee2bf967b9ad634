"""DINO (port of ssv_tpu/train/algorithms/dino.py): a student and a teacher
tower (ViT or ResNet, each with a `DinoHead`), multi-crop self-distillation
with a centred, sharpened teacher.

  * the towers are built and initialized separately; the teacher lives in
    `state.extra["teacher"]`, the center, a (1, proj_dim) buffer drawn
    N(0, 1) (`center_init: randn`, the reference) or zeros (`zeros`, the
    paper), in `state.extra["center"]`;
  * the teacher runs on the global views only, in train mode under
    `no_grad` (a ResNet teacher's BN uses batch statistics and advances its
    own, as the flax teacher's `batch_stats` do); the student runs on the
    globals, then on the locals;
  * the loss is 0.5 * (t1 against s2) + 0.5 * (t2 against s1), s_i being
    the student's global and local views of aug_i, at the teacher
    temperature of the step's epoch (linear warmup 0.04 -> 0.07 over 30
    epochs), against the center as it was before the step;
  * the optimizer (adamw in configs/dino.yaml) clamps each gradient element
    to +-`gradient_clip` and decays the weights by a cosine ramp over the
    epochs (0.04 -> 0.4);
  * after the step, the center moves to 0.9 * center + 0.1 * the mean of
    all the teacher's global outputs;
  * `teacher_update: epoch` (the reference) moves the teacher toward the
    student once an epoch, in `post_epoch`, at the cosine lambda of the
    epoch (0.996 -> 1.0); `step` (the paper) does it after every step at
    the cosine lambda of the global step;
  * `freeze_last_layer: N` keeps the head's `fc_out` as it is for the first
    N epochs (its update zeroed; Adam's moments still take its gradients,
    as in the JAX package), chosen on the device at each step;
  * the per-step numbers (the teacher temperature, the decay, the frozen
    flag, the step-wise lambda) are step tables read at the device counter
    (`step_tables`), so a step reads nothing on the host;
  * `fuse_views` (default: on for the ViT, whose LayerNorm couples no
    samples, off for BN towers) runs each group of same-size views as one
    forward.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...models.heads import DinoHead
from ...models.registry import build_encoder
from ...objectives.losses import dino_loss
from ...parallel import pmean
from ...state.ema import ema_update
from ...utils.schedules import cosine_ramp, dino_teacher_temp, dino_weight_decay
from ..base import Algorithm, DataInfo, TrainState
from .common import Tower, forward_views


class Center(nn.Module):
    """DINO's center, a (1, dim) buffer, so checkpoints carry it."""

    def __init__(self, value: torch.Tensor):
        super().__init__()
        self.register_buffer("value", value)


class DINO(Algorithm):
    name = "dino"
    batch_kind = "multicrop"

    def __init__(self, config, arch: str, data: DataInfo, device: torch.device):
        super().__init__(config, arch, data, device)
        head_cfg = dict(config["proj_head"])
        self.proj_dim = int(head_cfg["proj_dim"])
        encoder_cfg = self.encoder_cfg()
        towers = []
        for _ in range(2):
            encoder, dim = build_encoder(arch, encoder_cfg)
            towers.append(Tower(encoder, DinoHead(dim, int(head_cfg["hidden_dim"]),
                                                  self.proj_dim)))
        self.student, self.teacher = towers

        self.temp_student = float(config.get("student_temp", 0.1))
        self.temp_t_lower = float(config.get("teacher_temp_lower", 0.04))
        self.temp_t_upper = float(config.get("teacher_temp_upper", 0.07))
        self.temp_warmup_epochs = int(config.get("temp_warmup_epochs", 30))
        self.center_m = float(config.get("center_momentum", 0.9))
        self.lambda_lower = float(config.get("lambda_lower", 0.996))
        self.lambda_upper = float(config.get("lambda_upper", 1.0))
        self.wd_lower = float(config.get("weight_decay_lower", 0.04))
        self.wd_upper = float(config.get("weight_decay_upper", 0.4))
        self.grad_clip = config.get("gradient_clip")
        self.teacher_update = str(config.get("teacher_update", "epoch"))
        if self.teacher_update not in ("epoch", "step"):
            raise ValueError(
                f"teacher_update must be 'epoch' (faithful) or 'step' (paper "
                f"recipe), got {self.teacher_update!r}")
        self.center_init = str(config.get("center_init", "randn"))
        if self.center_init not in ("randn", "zeros"):
            raise ValueError(
                f"center_init must be 'randn' (faithful) or 'zeros' (paper), "
                f"got {self.center_init!r}")
        self.freeze_last_layer = int(config.get("freeze_last_layer", 0))
        fuse_cfg = config.get("fuse_views")
        self.fuse = (arch == "vit") if fuse_cfg is None else bool(fuse_cfg)

    def weight_decay(self, step: int) -> float:
        return dino_weight_decay(step // self.data.steps_per_epoch, lower=self.wd_lower,
                                 upper=self.wd_upper, epochs=self.epochs)

    def teacher_temp(self, epoch: int) -> float:
        return dino_teacher_temp(epoch, lower=self.temp_t_lower, upper=self.temp_t_upper,
                                 warmup_epochs=self.temp_warmup_epochs)

    def step_tables(self):
        spe = self.data.steps_per_epoch
        return {
            "teacher_temp": lambda s: self.teacher_temp(s // spe),
            "frozen": lambda s: float(s < self.freeze_last_layer * spe),
            "lambda": lambda s: cosine_ramp(s, self.total_steps, self.lambda_lower,
                                            self.lambda_upper),
        }

    def init_state(self, generator: torch.Generator) -> TrainState:
        student = self.place(self.student, generator)
        teacher = self.place(self.teacher, generator).requires_grad_(False)
        if self.center_init == "zeros":
            center = torch.zeros(1, self.proj_dim)
        else:
            center = torch.randn(1, self.proj_dim, generator=generator)
        optimizer, scheduler = self.make_optimizer(student, weight_decay_fn=self.weight_decay,
                                                   grad_clip=self.grad_clip)
        return TrainState(student, optimizer, scheduler, 0,
                          {"teacher": teacher, "center": Center(center).to(self.device)})

    def train_step(self, state: TrainState, batch: dict, generator=None):
        b, vg = batch["global_1"].shape[:2]
        vl = batch["local_1"].shape[1]
        g1, g2, l1, l2 = (batch[k].flatten(0, 1)
                          for k in ("global_1", "global_2", "local_1", "local_2"))
        temp_t = state.scheduler.at("teacher_temp")

        teacher = state.extra["teacher"].train()
        with torch.no_grad(), self.autocast():
            t1, t2 = (t.float().reshape(b, vg, -1)
                      for t in forward_views(teacher, [g1, g2], self.fuse))
        center = state.extra["center"].value

        model = state.model.train()
        with self.autocast():
            sg1, sg2 = forward_views(model, [g1, g2], self.fuse)
            sl1, sl2 = forward_views(model, [l1, l2], self.fuse)
        s1 = torch.cat([sg1.float().reshape(b, vg, -1), sl1.float().reshape(b, vl, -1)], 1)
        s2 = torch.cat([sg2.float().reshape(b, vg, -1), sl2.float().reshape(b, vl, -1)], 1)
        loss = (0.5 * dino_loss(t1, s2, self.temp_student, temp_t, center)
                + 0.5 * dino_loss(t2, s1, self.temp_student, temp_t, center))

        frozen = None
        if self.freeze_last_layer:
            frozen = (list(model.proj.fc_out.parameters()), state.scheduler.at("frozen") > 0)
        lbd = state.scheduler.at("lambda") if self.teacher_update == "step" else None
        state, loss = self.grad_step(state, loss, update_mask=frozen)

        with torch.no_grad():
            # the replica mean of equal-size slice means: the global batch's
            t_mean = pmean(torch.cat([t1.flatten(0, 1), t2.flatten(0, 1)])
                           .mean(dim=0, keepdim=True))
            center.copy_(self.center_m * center + (1 - self.center_m) * t_mean)
        if lbd is not None:
            ema_update(teacher.parameters(), model.parameters(), lbd)
        return state, {"loss": loss}

    def post_epoch(self, state: TrainState, epoch: int) -> TrainState:
        """The per-epoch teacher EMA at cosine lambda (reference
        dino.py:129-134,227); nothing under `teacher_update: step`."""
        if self.teacher_update == "epoch":
            lbd = cosine_ramp(epoch, self.epochs, self.lambda_lower, self.lambda_upper)
            ema_update(state.extra["teacher"].parameters(), state.model.parameters(), lbd)
        return state

    @torch.no_grad()
    def _eval(self, tower: nn.Module, images):
        tower.eval()
        with self.autocast():
            return tower(images).float()

    def embed(self, state: TrainState, images):
        """The student's head output, not re-normalized (reference
        build_features)."""
        return self._eval(state.model, images)

    def embed_backbone(self, state: TrainState, images):
        """The student encoder's features (the ViT's CLS), before the head."""
        return self._eval(state.model.encoder, images)

    def embed_teacher(self, state: TrainState, images):
        """The teacher's raw head outputs (before the center and softmax)."""
        return self._eval(state.extra["teacher"], images)

    def teacher_stats(self, state: TrainState, outputs) -> dict:
        """Scalars over raw teacher outputs (N, K), on the host in float64,
        over the teacher's effective distribution softmax((out - center) /
        temp_t): `mi` (entropy of the mean minus the mean entropy: 0 iff the
        teacher ignores the sample), `prob_std` (cross-sample std of the
        probabilities, mean over K), `raw_std` (the same of the raw outputs)
        and `ent_frac` (mean entropy / ln K). temp_t is that of the epoch of
        the last step taken (of epoch 0 before any step); the JAX package
        takes the epoch after it."""
        epoch = max(state.step - 1, 0) // self.data.steps_per_epoch
        temp = self.teacher_temp(epoch)
        out = np.asarray(torch.as_tensor(outputs).detach().cpu(), np.float64)
        center = state.extra["center"].value.detach().cpu().numpy().astype(np.float64)
        z = (out - center) / temp
        z -= z.max(1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(1, keepdims=True)
        eps = 1e-12
        ent = -(p * np.log(p + eps)).sum(1)
        pm = p.mean(0)
        ent_of_mean = float(-(pm * np.log(pm + eps)).sum())
        return {
            "mi": ent_of_mean - float(ent.mean()),
            "prob_std": float(p.std(0).mean()),
            "raw_std": float(out.std(0).mean()),
            "ent_frac": float(ent.mean() / np.log(p.shape[1])),
        }
