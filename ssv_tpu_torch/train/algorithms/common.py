"""Shared composite network (port of ssv_tpu/train/algorithms/common.py)."""

from __future__ import annotations

import torch
from torch import nn


class Tower(nn.Module):
    """encoder [+ projector]; NHWC images in, float32 features out."""

    def __init__(self, encoder: nn.Module, proj: nn.Module | None = None):
        super().__init__()
        self.encoder = encoder
        self.proj = proj

    def forward(self, x):
        z = self.encoder(x)
        if self.proj is not None:
            z = self.proj(z)
        return z

    def init_weights(self, generator: torch.Generator):
        self.encoder.init_weights(generator)
        if self.proj is not None:
            self.proj.init_weights(generator)
