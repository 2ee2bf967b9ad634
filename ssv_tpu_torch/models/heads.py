"""Projection heads (port of ssv_tpu/models/heads.py, the slice's part).

The head's Linear layers run in the caller's autocast dtype (bf16 on the
card) with f32 params; each BatchNorm takes and returns float32, and the
head's output is float32, as in the flax head.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import BatchNorm1d


class MLPHead(nn.Module):
    """MLP head driven by a layer spec: `widths` of the Linear layers,
    `bn_after` the (0-indexed) layers followed by BatchNorm, ReLU between
    layers and none after the last."""

    def __init__(self, in_dim: int, widths: Sequence[int],
                 bn_after: Sequence[int] = ()):
        super().__init__()
        dims = [in_dim, *widths]
        self.fc = nn.ModuleList(nn.Linear(dims[i], dims[i + 1])
                                for i in range(len(widths)))
        self.bn = nn.ModuleDict({str(i): BatchNorm1d(widths[i]) for i in bn_after})

    def forward(self, x):
        for i, fc in enumerate(self.fc):
            x = fc(x)
            if str(i) in self.bn:
                x = self.bn[str(i)](x.float())
            if i < len(self.fc) - 1:
                x = F.relu(x)
        return x.float()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax Dense defaults: lecun normal (truncated at 2 std, std
        corrected for the truncation) kernels, zero biases; BN 1 and 0."""
        for fc in self.fc:
            std = math.sqrt(1.0 / fc.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(fc.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(fc.bias)
        for bn in self.bn.values():
            nn.init.ones_(bn.weight)
            nn.init.zeros_(bn.bias)


def simclr_projection(input_dim: int, proj_dim: int) -> MLPHead:
    """fc(d,d)-bn-relu-fc(d,p)-bn (no final act)."""
    return MLPHead(input_dim, (input_dim, proj_dim), bn_after=(0, 1))
