"""DeepCluster (port of ssv_tpu/train/algorithms/deep_cluster.py): at each
epoch's start, K-means over the train split's normalized features, its
clusters matched to the classifier head's predictions (Hungarian), then
cross-entropy of the head against those pseudo-labels.

  * `DCNet`: the encoder's L2-normalized features, then `clf_head`, a
    float32 Dense as the flax one without a dtype is;
  * `pre_epoch`: `Trainer.map_train` gives the features and the head's
    argmax over the train split (eval transform, eval mode); `kmeans` with
    a generator seeded by the epoch (JAX: `PRNGKey(epoch)`), k =
    `num_classes`, `kmeans.n_iters` iterations, `kmeans.n_redo` restarts;
    the 10 x 10 vote matrix and its matching on the host; the lookup
    applied on the device. The labels live in `state.extra["pseudo_labels"]`,
    so checkpoints carry them;
  * the step trains on `aug_1` (the JAX package's divergence from the
    reference, whose pseudo-label loader cannot run); the `double` batch
    still builds `aug_2`, which nothing reads.
"""

from __future__ import annotations

import torch
from torch import nn

from ...evals.hungarian import hungarian_match
from ...models.heads import Float32Dense
from ...models.registry import build_encoder
from ...objectives.losses import l2_normalize, softmax_cross_entropy
from ...ops.kmeans import kmeans
from ..base import Algorithm, DataInfo, TrainState


class DCNet(nn.Module):
    """images -> (L2-normalized features, class logits)."""

    def __init__(self, encoder: nn.Module, dim: int, num_classes: int):
        super().__init__()
        self.encoder = encoder
        self.clf_head = Float32Dense(dim, num_classes)

    def forward(self, x):
        f = l2_normalize(self.encoder(x))
        return f, self.clf_head(f)

    def init_weights(self, generator: torch.Generator):
        self.encoder.init_weights(generator)
        self.clf_head.init_weights(generator)


class PseudoLabels(nn.Module):
    """One label per train image, zero at the start."""

    def __init__(self, n_train: int):
        super().__init__()
        self.register_buffer("labels", torch.zeros(n_train, dtype=torch.int64))


class DeepCluster(Algorithm):
    name = "deep_cluster"
    batch_kind = "double"

    def __init__(self, config, arch: str, data: DataInfo, device: torch.device):
        super().__init__(config, arch, data, device)
        self.num_classes = int(config.get("num_classes", data.num_classes))
        encoder, dim = build_encoder(arch, self.encoder_cfg())
        self.model = DCNet(encoder, dim, self.num_classes)
        km = dict(config.get("kmeans", {}) or {})
        self.kmeans_iters = int(km.get("n_iters", 300))
        self.kmeans_redo = int(km.get("n_redo", 10))

    def init_state(self, generator: torch.Generator) -> TrainState:
        model = self.place(self.model, generator)
        labels = PseudoLabels(self.data.n_train).to(self.device)
        optimizer, scheduler = self.make_optimizer(model)
        return TrainState(model, optimizer, scheduler, 0, {"pseudo_labels": labels})

    @torch.no_grad()
    def _features_and_preds(self, state: TrainState, images):
        state.model.eval()
        with self.autocast():
            f, logits = state.model(images)
        return f, logits.argmax(dim=-1)

    @torch.no_grad()
    def pre_epoch(self, state: TrainState, trainer, epoch: int) -> TrainState:
        feats, preds = trainer.map_train(state, self._features_and_preds)
        generator = torch.Generator(device=feats.device).manual_seed(int(epoch))
        _, clusters, _ = kmeans(generator, feats, k=self.num_classes,
                                n_iters=self.kmeans_iters, n_redo=self.kmeans_redo)
        cls_map = hungarian_match(clusters.cpu().numpy(), preds.cpu().numpy(),
                                  self.num_classes, self.num_classes)
        lut = torch.zeros(self.num_classes, dtype=torch.int64)
        for c, t in cls_map.items():
            lut[c] = t
        state.extra["pseudo_labels"].labels.copy_(lut.to(clusters.device)[clusters])
        return state

    def train_step(self, state: TrainState, batch: dict, generator=None):
        labels = state.extra["pseudo_labels"].labels[batch["index"]]
        state.model.train()
        with self.autocast():
            _, logits = state.model(batch["aug_1"])
        loss = softmax_cross_entropy(logits, labels)
        state, loss = self.grad_step(state, loss)
        return state, {"loss": loss}

    @torch.no_grad()
    def embed(self, state: TrainState, images):
        """The L2-normalized features."""
        state.model.eval()
        with self.autocast():
            f, _ = state.model(images)
        return f
