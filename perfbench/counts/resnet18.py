"""Forward FLOPs of ResNet-18 with the CIFAR stem (3x3/s1 convolution, the
3x3/s2 max-pool kept) on one image: every convolution, 2 FLOPs a
multiply-add; BN, ReLU, pooling and the sums count nothing."""

from __future__ import annotations

FEATURES = 512


def _conv(h, w, c_in, c_out, k, stride, pad):
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    return 2 * ho * wo * c_out * c_in * k * k, ho, wo


def forward_flops(cfg: dict, hw: tuple[int, int]) -> int:
    if not (cfg.get("encoder") or {}).get("reduce_bottom_conv"):
        raise ValueError("counted for the CIFAR stem (reduce_bottom_conv) only")
    h, w = hw
    total, h, w = _conv(h, w, 3, 64, 3, 1, 1)
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1       # max-pool 3/2, pad 1
    c_in = 64
    for s, c in enumerate((64, 128, 256, 512)):
        for b in range(2):
            stride = 2 if (s > 0 and b == 0) else 1
            f1, ho, wo = _conv(h, w, c_in, c, 3, stride, 1)
            f2, _, _ = _conv(ho, wo, c, c, 3, 1, 1)
            total += f1 + f2
            if stride != 1 or c_in != c:
                total += _conv(h, w, c_in, c, 1, stride, 0)[0]
            h, w, c_in = ho, wo, c
    return total
