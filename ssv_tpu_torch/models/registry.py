"""Backbone registry (port of ssv_tpu/models/registry.py)."""

from __future__ import annotations

from . import resnet

NETWORKS = {
    "resnet18": {"net": resnet.resnet18, "dim": 512},
    "resnet34": {"net": resnet.resnet34, "dim": 512},
}

# archs of the JAX package that the port does not build yet
NOT_PORTED = {"tiny": "C", "resnet50": "C", "resnet101": "C", "resnet152": "C",
              "resnext50": "C", "resnext101": "C", "wide_resnet50": "C",
              "wide_resnet101": "C", "vit": "B"}


def build_encoder(arch: str, encoder_cfg: dict):
    """Instantiate a backbone module + its feature dim from the YAML
    `encoder` block. Keys meant for other backbones are ignored, as in the
    JAX registry; compute dtype comes from the algorithm's autocast."""
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not yet ported to ssv_tpu_torch "
            f"(ROADMAP slice {NOT_PORTED[arch]})")
    if arch not in NETWORKS:
        raise ValueError(f"Unknown arch {arch!r}; expected one of {list(NETWORKS)}")
    allowed = {"reduce_bottom_conv", "zero_init_residual"}
    cfg = {k: v for k, v in dict(encoder_cfg or {}).items() if k in allowed}
    entry = NETWORKS[arch]
    return entry["net"](**cfg), entry["dim"]
