"""ResNet-18 (arXiv:1512.03385) with the CIFAR stem, functional, in plain
PyTorch: the reference's backbone.

The stem is a 3x3 stride-1 convolution (`reduce_bottom_conv`), BN, ReLU
and the 3x3 stride-2 max-pool; then four stages of two BasicBlocks at 64,
128, 256 and 512 channels, the first block of stages 2-4 at stride 2 with a
1x1 strided convolution and BN on its shortcut; then the global mean.
BatchNorm takes the batch's statistics (training mode), the biased
variance, eps 1e-5. Convolutions have no bias. The max-pool runs on a
channels-last tensor (see `forward`).

Parameters live in a flat dict under the names the benchmark hands to
both sides (`encoder.layer1.0.conv1.weight`, ...); `specs` lists them in
order with their shapes and how the benchmark draws them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

STAGES = (64, 128, 256, 512)
BLOCKS = 2
EPS = 1e-5


def _blocks():
    """(prefix, in, out, stride) of every BasicBlock."""
    c_in = 64
    for s, c in enumerate(STAGES):
        for b in range(BLOCKS):
            stride = 2 if (s > 0 and b == 0) else 1
            yield f"layer{s + 1}.{b}", c_in, c, stride
            c_in = c


def specs(prefix: str, cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter: init is `conv` (normal with
    std sqrt(2 / fan_out)), `one` or `zero`."""
    if not (cfg.get("encoder") or {}).get("reduce_bottom_conv"):
        raise ValueError("the reference ResNet-18 has the CIFAR stem only")
    out = [(f"{prefix}conv1.weight", (64, 3, 3, 3), "conv")]
    out += [(f"{prefix}bn1.weight", (64,), "one"), (f"{prefix}bn1.bias", (64,), "zero")]
    for p, c_in, c, stride in _blocks():
        out += [(f"{prefix}{p}.conv1.weight", (c, c_in, 3, 3), "conv"),
                (f"{prefix}{p}.bn1.weight", (c,), "one"), (f"{prefix}{p}.bn1.bias", (c,), "zero"),
                (f"{prefix}{p}.conv2.weight", (c, c, 3, 3), "conv"),
                (f"{prefix}{p}.bn2.weight", (c,), "one"), (f"{prefix}{p}.bn2.bias", (c,), "zero")]
        if stride != 1 or c_in != c:
            out += [(f"{prefix}{p}.downsample.0.weight", (c, c_in, 1, 1), "conv"),
                    (f"{prefix}{p}.downsample.1.weight", (c,), "one"),
                    (f"{prefix}{p}.downsample.1.bias", (c,), "zero")]
    return out


def batch_norm(x, weight, bias, dims):
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    shape = [1] * x.dim()
    shape[1] = -1
    return (x - mean) * torch.rsqrt(var + EPS) * weight.reshape(shape) + bias.reshape(shape)


def forward(params: dict, prefix: str, x_nhwc, cast=lambda t: t):
    """(B, H, W, 3) float32 -> (B, 512) features. `cast` rounds every
    tensor a mixed-precision run keeps in its low precision: each
    convolution's operands and result, each BN's output and each residual
    sum (the identity in float32)."""
    def conv(x, name, stride, pad):
        return cast(F.conv2d(cast(x), cast(params[prefix + name]), stride=stride, padding=pad))

    def bn(x, name):
        return cast(batch_norm(x, params[prefix + name + ".weight"],
                               params[prefix + name + ".bias"], (0, 2, 3)))

    x = x_nhwc.permute(0, 3, 1, 2)
    # where a window's maximum is tied (flat regions of clamped, upsampled
    # images), its gradient goes to one of the tied inputs, which one the
    # kernel decides: a channels-last input, as the port's, routes ties alike
    x = F.relu(bn(conv(x, "conv1.weight", 1, 1), "bn1"))
    x = F.max_pool2d(x.contiguous(memory_format=torch.channels_last), 3, 2, 1)
    for p, c_in, c, stride in _blocks():
        y = F.relu(bn(conv(x, f"{p}.conv1.weight", stride, 1), f"{p}.bn1"))
        y = bn(conv(y, f"{p}.conv2.weight", 1, 1), f"{p}.bn2")
        if stride != 1 or c_in != c:
            x = bn(conv(x, f"{p}.downsample.0.weight", stride, 0), f"{p}.downsample.1")
        x = F.relu(cast(y + x))
    return x.mean(dim=(2, 3))


FEATURES = STAGES[-1]
