"""SeLA (port of ssv_tpu/train/algorithms/sela.py): linear cluster heads over
the backbone, trained with cross-entropy against pseudo-labels that a
self-labelling sweep over the train split assigns; the loss sums the heads'
losses, and the head with the least loss labels the next sweep.

  * `state.extra["self_label"]` holds alpha (clusters, 1), beta (batch, 1),
    `pseudo_labels` (n_train,) and `best_head` as buffers of one module;
  * a sweep runs at `pre_train` and at the start of each epoch of
    `sl_epochs`, quadratically spaced: {int(epochs * (i / (n - 1))**2)} for
    i in 1..n-2 with n = `self_label_iters`;
  * `self_label_mode: sinkhorn` (the default) labels each batch by the
    argmax of `sinkhorn_codes` with eps = 1/lambda and min(n, 30)
    iterations; `reference` by `sela_self_label`, alpha and beta threaded
    from batch to batch. The sweep streams the split through
    `Trainer.stream_train`; logits and labels stay on the device, one index
    write a batch.
"""

from __future__ import annotations

import torch
from torch import nn

from ...models.heads import ClusterHeads
from ...models.registry import build_encoder
from ...objectives.losses import sela_self_label, sinkhorn_codes
from ...parallel import pmean
from ..base import Algorithm, DataInfo, TrainState

SELF_LABEL_MODES = ("sinkhorn", "reference")


class SelaNet(nn.Module):
    """The encoder and its cluster heads: images -> (features, (heads, batch,
    clusters) logits)."""

    def __init__(self, encoder: nn.Module, dim: int, num_heads: int, num_clusters: int):
        super().__init__()
        self.encoder = encoder
        self.cluster_heads = ClusterHeads(dim, num_heads, num_clusters)

    def forward(self, x):
        f = self.encoder(x)
        return f, self.cluster_heads(f)

    def init_weights(self, generator: torch.Generator):
        self.encoder.init_weights(generator)
        self.cluster_heads.init_weights(generator)


class SelfLabelState(nn.Module):
    """The self-labelling state that is not weights: alpha and beta drawn
    N(0, 1), the pseudo-labels and the best head, zero at the start."""

    def __init__(self, num_clusters: int, batch_size: int, n_train: int):
        super().__init__()
        self.register_buffer("alpha", torch.empty(num_clusters, 1))
        self.register_buffer("beta", torch.empty(batch_size, 1))
        self.register_buffer("pseudo_labels", torch.zeros(n_train, dtype=torch.int64))
        self.register_buffer("best_head", torch.zeros((), dtype=torch.int64))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        self.alpha.normal_(generator=generator)
        self.beta.normal_(generator=generator)


def self_label_epochs(epochs: int, n: int) -> set[int]:
    return {int(epochs * (i / (n - 1)) ** 2) for i in range(1, n - 1)}


class SeLA(Algorithm):
    name = "sela"
    batch_kind = "pseudolabel"

    def __init__(self, config, arch: str, data: DataInfo, device: torch.device):
        super().__init__(config, arch, data, device)
        self.num_clusters = int(config["num_clusters"])
        self.num_heads = int(config["num_cluster_heads"])
        self.lmbda = float(config["lambda"])
        self.sl_iters = int(config["self_label_iters"])
        self.sl_mode = str(config.get("self_label_mode", "sinkhorn"))
        if self.sl_mode not in SELF_LABEL_MODES:
            raise ValueError(f"self_label_mode must be one of {SELF_LABEL_MODES}, "
                             f"got {self.sl_mode!r}")
        encoder, dim = build_encoder(arch, self.encoder_cfg())
        self.model = SelaNet(encoder, dim, self.num_heads, self.num_clusters)
        self.sl_epochs = self_label_epochs(self.epochs, self.sl_iters)

    def init_state(self, generator: torch.Generator) -> TrainState:
        model = self.place(self.model, generator)
        labels = SelfLabelState(self.num_clusters, self.data.batch_size, self.data.n_train)
        labels.init_weights(generator)
        optimizer, scheduler = self.make_optimizer(model)
        return TrainState(model, optimizer, scheduler, 0,
                          {"self_label": labels.to(self.device)})

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _best_head_logits(self, state: TrainState, images):
        """The best head's (batch, clusters) logits in eval mode; the head is
        picked on the device, without a read to the host."""
        state.model.eval()
        with self.autocast():
            _, logits = state.model(images)
        return logits.index_select(0, state.extra["self_label"].best_head.reshape(1))[0]

    @torch.no_grad()
    def self_label(self, state: TrainState, trainer) -> TrainState:
        """One self-labelling sweep over the train split."""
        sl = state.extra["self_label"]
        alpha, beta = sl.alpha, sl.beta
        for logits, idx, count in trainer.stream_train(state, self._best_head_logits):
            if self.sl_mode == "sinkhorn":
                labels = sinkhorn_codes(logits, eps=1.0 / max(self.lmbda, 1e-6),
                                        n_iters=min(self.sl_iters, 30)).argmax(dim=-1)
            else:
                labels, alpha, beta = sela_self_label(logits, alpha, beta,
                                                      lmbda=self.lmbda,
                                                      n_iters=self.sl_iters)
            sl.pseudo_labels[idx[:count]] = labels[:count]
        sl.alpha.copy_(alpha)
        sl.beta.copy_(beta)
        return state

    def pre_train(self, state: TrainState, trainer) -> TrainState:
        return self.self_label(state, trainer)

    def pre_epoch(self, state: TrainState, trainer, epoch: int) -> TrainState:
        if epoch in self.sl_epochs:
            return self.self_label(state, trainer)
        return state

    # ------------------------------------------------------------------
    def train_step(self, state: TrainState, batch: dict, generator=None):
        sl = state.extra["self_label"]
        labels = sl.pseudo_labels[batch["idx"]]
        state.model.train()
        with self.autocast():
            _, logits = state.model(batch["aug"])
        logp = torch.log_softmax(logits, dim=-1)                   # (heads, B, K)
        index = labels[None, :, None].expand(logp.shape[0], -1, 1)
        per_head = -torch.gather(logp, -1, index)[..., 0].mean(dim=1)
        loss = per_head.sum()
        state, loss = self.grad_step(state, loss)
        # the head with the least loss over the global batch, on every rank
        sl.best_head.copy_(pmean(per_head).argmin())
        return state, {"loss": loss}

    @torch.no_grad()
    def embed(self, state: TrainState, images):
        """The backbone's features."""
        state.model.eval()
        with self.autocast():
            f, _ = state.model(images)
        return f.float()
