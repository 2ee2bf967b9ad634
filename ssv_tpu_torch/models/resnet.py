"""ResNet backbones in PyTorch (port of ssv_tpu/models/resnet.py).

BasicBlock and Bottleneck ResNets, ResNeXt (a grouped 3x3 in the
Bottleneck) and Wide ResNets (a wider Bottleneck), with the
`reduce_bottom_conv` CIFAR stem (3x3/s1 instead of 7x7/s2), kaiming
fan-out normal init and optional zero-init residual (the last BN of each
block starts at 0).
The public forward takes the JAX package's NHWC layout and returns pooled,
flattened float32 features with no classifier head. Inside, an NHWC tensor
is viewed as channels-last NCHW (`permute`, no copy) for cuDNN.

Mixed precision is the caller's `torch.autocast` (bf16 compute, f32 params,
f32 BN statistics), as `dtype=bfloat16` is in the flax module, unless the
module is given its own compute `dtype`: float32 runs it with autocast off
on float32 inputs, bfloat16 under bf16 autocast, whatever the caller's
region, as the flax module's `dtype` does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..parallel.mesh import data_size
from ..parallel.per_device import all_reduce_sum


class _FlaxRunningVar:
    """BatchNorm whose running variance tracks the *biased* batch variance,
    as flax's does; torch's own tracks the unbiased one. Flax
    `momentum=0.9` is torch `momentum=0.1`.

    With `sync` set (`parallel.sync_batchnorm`) and more than one data rank,
    a training forward takes its statistics over the global batch: each
    channel's count, sum and sum of squares, all-reduced over the data group
    with gradients (the model ranks of a row hold the same rows, so the
    world would count them M times in the backward),
    give the mean and the biased variance as flax computes them (mean of
    x and of x^2, var = max(0, E[x^2] - mean^2)). Otherwise it is torch's
    BatchNorm with the running-variance correction below."""

    sync = False

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.sync and data_size() > 1:
            return self._global_forward(x)
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

    def _global_forward(self, x):
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = [1, c] + [1] * (x.dim() - 2)
        xf = x.float()
        count = xf.new_full((1,), x.numel() // c)
        sums = all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]))
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * scale.reshape(shape) + self.bias.reshape(shape)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
            self.running_var.mul_(keep).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)


def _conv(in_planes, planes, kernel, stride=1, padding=0, groups=1):
    return nn.Conv2d(in_planes, planes, kernel, stride=stride, padding=padding,
                     groups=groups, bias=False)


def _downsample(in_planes, planes, stride):
    """The shortcut's strided 1x1 conv and BN (flax's `SAME` padding of a
    1x1 conv is none)."""
    return nn.Sequential(_conv(in_planes, planes, 1, stride), BatchNorm2d(planes))


class BasicBlock(nn.Module):
    expansion = 1
    last_bn = "bn2"   # zeroed by zero_init_residual

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1, base_width=64")
        self.conv1 = _conv(in_planes, planes, 3, stride, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (_downsample(in_planes, planes * self.expansion, stride)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + identity)


class Bottleneck(nn.Module):
    """1x1 conv to `width` -> 3x3 conv (the stride and the groups here) ->
    1x1 conv to planes * 4, each followed by BN, ReLU after the first two
    and after the residual sum."""
    expansion = 4
    last_bn = "bn3"

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * base_width / 64) * groups
        self.conv1 = _conv(in_planes, width, 1)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride, 1, groups)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = _conv(width, planes * self.expansion, 1)
        self.bn3 = BatchNorm2d(planes * self.expansion)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (_downsample(in_planes, planes * self.expansion, stride)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


class ResNet(nn.Module):
    """Feature extractor: (B, H, W, 3) -> (B, 64 * 2**(stages-1) * expansion),
    (B, 512) for BasicBlock and (B, 2048) for Bottleneck at four stages."""

    def __init__(self, block: type, stage_sizes: Sequence[int], groups: int = 1,
                 width_per_group: int = 64, reduce_bottom_conv: bool = False,
                 zero_init_residual: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
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
                blocks.append(block(in_planes, planes, stride, downsample, groups,
                                    width_per_group))
                in_planes = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.zero_init_residual = zero_init_residual

    def forward(self, x):
        if self.dtype is None:
            return self._features(x)
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            return self._features(x.float())

    def _features(self, x):
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
                if isinstance(m, (BasicBlock, Bottleneck)):
                    nn.init.zeros_(getattr(m, m.last_bn).weight)


def _factory(block, stages, **defaults):
    def make(**kwargs) -> ResNet:
        return ResNet(block, stages, **{**defaults, **kwargs})
    return make


resnet18 = _factory(BasicBlock, (2, 2, 2, 2))
resnet34 = _factory(BasicBlock, (3, 4, 6, 3))
resnet50 = _factory(Bottleneck, (3, 4, 6, 3))
resnet101 = _factory(Bottleneck, (3, 4, 23, 3))
resnet152 = _factory(Bottleneck, (3, 8, 36, 3))
resnext50_32x4d = _factory(Bottleneck, (3, 4, 6, 3), groups=32, width_per_group=4)
resnext101_32x8d = _factory(Bottleneck, (3, 4, 23, 3), groups=32, width_per_group=8)
wide_resnet50_2 = _factory(Bottleneck, (3, 4, 6, 3), width_per_group=128)
wide_resnet101_2 = _factory(Bottleneck, (3, 4, 23, 3), width_per_group=128)
