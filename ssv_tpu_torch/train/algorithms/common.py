"""Shared composite network (port of ssv_tpu/train/algorithms/common.py):
encoder [+ projector [+ predictor]], with an optional L2-normalized output."""

from __future__ import annotations

import torch
from torch import nn

from ...objectives.losses import l2_normalize


class Tower(nn.Module):
    """encoder [+ projector [+ predictor]]; NHWC images in, float32 features
    out (the heads return float32)."""

    def __init__(self, encoder: nn.Module, proj: nn.Module | None = None,
                 pred: nn.Module | None = None, norm_out: bool = False):
        super().__init__()
        self.encoder = encoder
        self.proj = proj
        self.pred = pred
        self.norm_out = norm_out

    def forward(self, x, use_pred: bool = True, return_pair: bool = False):
        z = self.encoder(x)
        if self.proj is not None:
            z = self.proj(z)
        if return_pair and self.pred is not None:
            # (projector out, predictor out) from one pass: SimSiam's
            # stop-grad target is an intermediate of its predictor path
            p = self.pred(z)
            if self.norm_out:
                return l2_normalize(z), l2_normalize(p)
            return z, p
        if self.pred is not None and use_pred:
            z = self.pred(z)
        if self.norm_out:
            z = l2_normalize(z)
        return z

    def init_weights(self, generator: torch.Generator):
        for part in (self.encoder, self.proj, self.pred):
            if part is not None:
                part.init_weights(generator)


def forward_views(model: nn.Module, views: list, fuse: bool) -> list:
    """Encodes same-shape view batches through one tower, in the caller's
    grad and autocast mode. `fuse=True` runs one forward of the concatenated
    views, so BatchNorm sees the union batch and its running statistics
    advance once; `fuse=False` runs one forward per view, as the reference
    trainers do, and they advance once per view."""
    if fuse:
        return list(model(torch.cat(views)).chunk(len(views)))
    return [model(v) for v in views]
