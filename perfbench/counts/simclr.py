"""FLOPs an image of a SimCLR training step: both views through the tower
(backbone and projection fc(d,d), fc(d,p)) forward and backward, counted
as 3 x forward, and the NT-Xent's 2N x 2N similarity product (2N x p by
p x 2N for the step's N images), forward and backward, 3 x."""

from __future__ import annotations

import importlib


def tower_flops(cfg: dict, hw) -> int:
    arch = importlib.import_module(f"{__package__}.{cfg['arch']}")
    d, p = arch.FEATURES, int(cfg["proj_dim"])
    return arch.forward_flops(cfg, hw) + 2 * (d * d + d * p)


def flops_per_image(cfg: dict, hw, batch: int) -> float:
    p = int(cfg["proj_dim"])
    similarity = 2 * (2 * batch) ** 2 * p
    return 2 * 3 * tower_flops(cfg, hw) + 3 * similarity / batch
