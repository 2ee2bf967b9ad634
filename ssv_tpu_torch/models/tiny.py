"""A minimal CNN encoder for fast tests and examples (port of
ssv_tpu/models/tiny.py, the JAX tests' small backbone).

Two stride-2 3x3 convs with bias (to 32 channels, then `features`), each
followed by a float32 BatchNorm and ReLU, then a mean pool: (B, H, W, 3) ->
(B, features) float32. The convs pad as flax's default `SAME` does, from
the input's size (0 before and 1 after on an even size), not symmetrically.
The BNs take and return float32, as flax's `dtype=float32` BNs do under a
bf16 encoder; the next conv runs in the compute dtype again.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .heads import _lecun_trunc_normal_
from .resnet import BatchNorm2d

TINY_DIM = 64


def _same_pad(n: int, kernel: int = 3, stride: int = 2) -> tuple[int, int]:
    """flax/XLA `SAME` padding of one axis of size n: (before, after)."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class TinyEncoder(nn.Module):
    """`reduce_bottom_conv` and `zero_init_residual` are accepted and
    ignored, as in the flax module; `dtype` as the ResNet's."""

    def __init__(self, features: int = TINY_DIM, reduce_bottom_conv: bool = True,
                 zero_init_residual: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 32, 3, stride=2)
        self.bn1 = BatchNorm2d(32)
        self.conv2 = nn.Conv2d(32, features, 3, stride=2)
        self.bn2 = BatchNorm2d(features)

    def forward(self, x):
        if self.dtype is None:
            return self._features(x)
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            return self._features(x.float())

    @staticmethod
    def _conv(conv: nn.Conv2d, x):
        """The conv with `SAME` padding, its product rounded to its dtype
        before the bias is added in that dtype, as flax's Conv computes."""
        (top, bottom), (left, right) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
        y = F.conv2d(F.pad(x, (left, right, top, bottom)), conv.weight, stride=2)
        return y + conv.bias.to(y.dtype).reshape(1, -1, 1, 1)

    def _features(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels-last in memory
        x = torch.relu(self.bn1(self._conv(self.conv1, x).float()))
        x = torch.relu(self.bn2(self._conv(self.conv2, x).float()))
        return x.mean(dim=(2, 3))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax Conv defaults: lecun normal (truncated) kernels with fan_in
        9 * in, zero biases; BN 1 and 0."""
        for conv in (self.conv1, self.conv2):
            _lecun_trunc_normal_(conv.weight, conv.weight[0].numel(), generator)
            nn.init.zeros_(conv.bias)
        for bn in (self.bn1, self.bn2):
            nn.init.ones_(bn.weight)
            nn.init.zeros_(bn.bias)
