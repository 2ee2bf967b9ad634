"""ResNet backbones in PyTorch (port of ssv_tpu/models/resnet.py).

BasicBlock ResNets with the `reduce_bottom_conv` CIFAR stem (3x3/s1 instead
of 7x7/s2), kaiming fan-out normal init and optional zero-init residual.
The public forward takes the JAX package's NHWC layout and returns pooled,
flattened float32 features with no classifier head. Inside, an NHWC tensor
is viewed as channels-last NCHW (`permute`, no copy) for cuDNN.

Mixed precision is the caller's `torch.autocast` (bf16 compute, f32 params,
f32 BN statistics), as `dtype=bfloat16` is in the flax module.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class _FlaxRunningVar:
    """BatchNorm whose running variance tracks the *biased* batch variance,
    as flax's does; torch's own tracks the unbiased one. Flax
    `momentum=0.9` is torch `momentum=0.1`."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        keep = 1.0 - self.momentum
        old = self.running_var.clone()
        out = super().forward(x)
        # torch added momentum * var * n/(n-1); scale that share by (n-1)/n.
        # `.data`: the BN node saved running_var as an input, and backward
        # never reads it, so this update must not bump its version.
        rv = self.running_var.data
        rv.sub_(old, alpha=keep).mul_((n - 1) / n).add_(old, alpha=keep)
        return out


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)


def _conv(in_planes, planes, kernel, stride=1, padding=0):
    return nn.Conv2d(in_planes, planes, kernel, stride=stride, padding=padding,
                     bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(
            _conv(in_planes, planes * self.expansion, 1, stride),
            BatchNorm2d(planes * self.expansion)) if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + identity)


class ResNet(nn.Module):
    """Feature extractor: (B, H, W, 3) -> (B, 64 * 2**(stages-1) * expansion)."""

    def __init__(self, block: type, stage_sizes: Sequence[int],
                 reduce_bottom_conv: bool = False, zero_init_residual: bool = False):
        super().__init__()
        if reduce_bottom_conv:
            self.conv1 = _conv(3, 64, 3, 1, 1)
        else:
            self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_planes = 64
        for stage, n_blocks in enumerate(stage_sizes):
            planes = 64 * 2 ** stage
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                downsample = stride != 1 or in_planes != planes * block.expansion
                blocks.append(block(in_planes, planes, stride, downsample))
                in_planes = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.zero_init_residual = zero_init_residual

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels-last in memory
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean(dim=(2, 3)).float()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Kaiming fan-out normal convs, BN scale 1 and bias 0 (the last BN
        of each block starts at 0 with zero_init_residual)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu", generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        if self.zero_init_residual:
            for m in self.modules():
                if isinstance(m, BasicBlock):
                    nn.init.zeros_(m.bn2.weight)


def resnet18(**kwargs) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), **kwargs)


def resnet34(**kwargs) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), **kwargs)
