"""PIRL (port of ssv_tpu/train/algorithms/pirl.py): the image's features
against those of its jigsaw, through NCE against a per-sample EMA bank with
sampled negatives.

  * `PirlNet`: `f_proj` over the encoder for the image (`aug_1`); the other
    view (`aug_2`) is cut into its n patches, and all B * n of them go
    through one encoder forward, enumerated column-major over (x, y) as the
    JAX reshape (B, gh, p, gw, p, C) -> (0, 3, 1, 2, 4, 5) does; then
    `g_proj_head_initial`, one permutation of the n patch features shared by
    the batch, and `g_proj_head_final` over their concatenation. The three
    Dense layers are float32, as the flax ones without a dtype are;
  * the encoder runs twice in one forward (the image, then the patches), so
    its BatchNorm running statistics advance twice a step, in that order, as
    flax's mutable `batch_stats` do;
  * the bank (`state.extra["bank"]`, a `SampleBank` of n_train rows) is
    filled at `pre_train` from the raw `f_proj` outputs of the train split
    (normalized on write); after each optimizer step the batch's rows take
    an EMA of the detached image features;
  * `draw` takes the step's permutation, then its negatives, from the step's
    generator;
  * `loss_fn.negatives_from` defaults to "features", the corrected NCE;
    "memory" keeps the reference's quirk (objectives/losses.py `pirl_nce`).
"""

from __future__ import annotations

import torch
from torch import nn

from ...models.heads import Float32Dense
from ...models.registry import build_encoder
from ...objectives.losses import l2_normalize, pirl_nce
from ...parallel import pgather
from ...state.banks import SampleBank, sample_bank_set, sample_bank_update, sample_negatives
from ..base import Algorithm, DataInfo, TrainState


class PirlNet(nn.Module):
    """images -> f_proj features; with `patch_imgs`, (image features, the
    jigsaw's features)."""

    def __init__(self, encoder: nn.Module, dim: int, proj_dim: int, patch_size: int,
                 num_patches: int):
        super().__init__()
        self.encoder = encoder
        self.patch_size = patch_size
        self.f_proj = Float32Dense(dim, proj_dim)
        self.g_proj_head_initial = Float32Dense(dim, proj_dim)
        self.g_proj_head_final = Float32Dense(num_patches * proj_dim, proj_dim)

    def forward(self, imgs, patch_imgs=None, perm=None):
        img_features = self.f_proj(self.encoder(imgs))
        if patch_imgs is None:
            return img_features
        b, h, w, c = patch_imgs.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        patches = (patch_imgs.reshape(b, gh, p, gw, p, c).permute(0, 3, 1, 2, 4, 5)
                   .reshape(b * gh * gw, p, p, c))
        pf = self.g_proj_head_initial(self.encoder(patches)).reshape(b, gh * gw, -1)
        if perm is not None:
            pf = pf[:, perm]
        return img_features, self.g_proj_head_final(pf.reshape(b, -1))

    def init_weights(self, generator: torch.Generator):
        for part in (self.encoder, self.f_proj, self.g_proj_head_initial,
                     self.g_proj_head_final):
            part.init_weights(generator)


class PIRL(Algorithm):
    name = "pirl"
    batch_kind = "double"

    def __init__(self, config, arch: str, data: DataInfo, device: torch.device):
        super().__init__(config, arch, data, device)
        self.proj_dim = int(config["proj_dim"])
        self.num_patches = int(config.get("num_patches", 4))
        self.m = float(config.get("momentum", 0.5))
        self.num_negatives = int(config.get("num_negatives", 1000))
        encoder, dim = build_encoder(arch, self.encoder_cfg())
        self.model = PirlNet(encoder, dim, self.proj_dim, int(config.get("patch_size", 16)),
                             self.num_patches)
        self.loss_cfg = dict(config.get("loss_fn", {}) or {})
        self.loss_cfg.setdefault("negatives_from", "features")

    def init_state(self, generator: torch.Generator) -> TrainState:
        model = self.place(self.model, generator)
        bank = SampleBank(self.data.n_train, self.proj_dim).to(self.device)
        optimizer, scheduler = self.make_optimizer(model)
        return TrainState(model, optimizer, scheduler, 0, {"bank": bank})

    def pre_train(self, state: TrainState, trainer) -> TrainState:
        fvecs, _ = trainer.features_for(state, "train", feature_fn=self._bank_feature)
        sample_bank_set(state.extra["bank"],
                        torch.arange(self.data.n_train, device=fvecs.device), fvecs)
        return state

    @torch.no_grad()
    def _bank_feature(self, state: TrainState, images):
        """The raw f_proj output in eval mode."""
        state.model.eval()
        with self.autocast():
            return state.model(images)

    def draw(self, generator: torch.Generator, bank: SampleBank, idx):
        """The step's draws: the patch permutation, then the negative rows."""
        perm = torch.randperm(self.num_patches, generator=generator, device=self.device)
        return perm, sample_negatives(generator, bank, idx, self.num_negatives)

    def train_step(self, state: TrainState, batch: dict, generator: torch.Generator):
        bank, idx = state.extra["bank"], batch["index"]
        perm, mem_neg = self.draw(generator, bank, idx)
        mem_pos = bank.data[idx]
        state.model.train()
        with self.autocast():
            img_f, patch_f = state.model(batch["aug_1"], batch["aug_2"], perm)
        loss = pirl_nce(img_f, patch_f, mem_pos, mem_neg, **self.loss_cfg)
        state, loss = self.grad_step(state, loss)
        # the bank takes the global batch's rows, the same on every rank
        sample_bank_update(bank, pgather(idx), pgather(img_f.detach()), self.m)
        return state, {"loss": loss}

    @torch.no_grad()
    def embed(self, state: TrainState, images):
        return l2_normalize(self._bank_feature(state, images))
