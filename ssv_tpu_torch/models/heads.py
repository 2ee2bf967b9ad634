"""Projection heads (port of ssv_tpu/models/heads.py: the MLP heads of SimCLR,
BYOL and ReLIC, SimSiam and Barlow Twins).

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

from ..objectives.losses import l2_normalize
from .resnet import BatchNorm1d


class MLPHead(nn.Module):
    """MLP head driven by a layer spec: `widths` of the Linear layers,
    `bn_after` the (0-indexed) layers followed by BatchNorm, ReLU between
    layers and none after the last; `l2_norm_out` L2-normalizes the output."""

    def __init__(self, in_dim: int, widths: Sequence[int],
                 bn_after: Sequence[int] = (), l2_norm_out: bool = False):
        super().__init__()
        self.l2_norm_out = l2_norm_out
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
        x = x.float()
        return l2_normalize(x) if self.l2_norm_out else x

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


def byol_mlp(input_dim: int, output_dim: int) -> MLPHead:
    """fc(d,d)-bn-relu-fc(d,p): BYOL's and ReLIC's projector and predictor."""
    return MLPHead(input_dim, (input_dim, output_dim), bn_after=(0,))


def simsiam_projector(input_dim: int, proj_dim: int) -> MLPHead:
    """fc(d,p)-bn-relu-fc(p,p)-bn-relu-fc(p,p)-bn."""
    return MLPHead(input_dim, (proj_dim, proj_dim, proj_dim), bn_after=(0, 1, 2))


def simsiam_predictor(proj_dim: int, bottleneck_dim: int) -> MLPHead:
    """fc(p,b)-bn-relu-fc(b,p)."""
    return MLPHead(proj_dim, (bottleneck_dim, proj_dim), bn_after=(0,))


def barlow_projection(input_dim: int, proj_dim: int) -> MLPHead:
    """fc(d,p)-bn-relu-fc(p,p)-bn-relu-fc(p,p), L2-normalized output."""
    return MLPHead(input_dim, (proj_dim, proj_dim, proj_dim), bn_after=(0, 1),
                   l2_norm_out=True)
