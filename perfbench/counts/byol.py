"""FLOPs an image of a BYOL training step: both views through the online
tower (backbone, projector fc(d,d), fc(d,p), predictor fc(p,p), fc(p,p))
forward and backward, 3 x forward, and through the target tower (backbone
and projector) forward only, 1 x. The loss has no matrix product."""

from __future__ import annotations

import importlib


def flops_per_image(cfg: dict, hw, batch: int) -> float:
    arch = importlib.import_module(f"{__package__}.{cfg['arch']}")
    d, p = arch.FEATURES, int(cfg["proj_dim"])
    backbone = arch.forward_flops(cfg, hw)
    proj, pred = 2 * (d * d + d * p), 2 * (p * p + p * p)
    return 2 * (3 * (backbone + proj + pred) + (backbone + proj))
