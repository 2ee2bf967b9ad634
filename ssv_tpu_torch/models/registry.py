"""Backbone registry (port of ssv_tpu/models/registry.py)."""

from __future__ import annotations

from . import resnet, vit

NETWORKS = {
    "resnet18": {"net": resnet.resnet18, "dim": 512},
    "resnet34": {"net": resnet.resnet34, "dim": 512},
}

# archs of the JAX package that the port does not build yet
NOT_PORTED = {"tiny": "C", "resnet50": "C", "resnet101": "C", "resnet152": "C",
              "resnext50": "C", "resnext101": "C", "wide_resnet50": "C",
              "wide_resnet101": "C"}

VIT_KEYS = ("hidden_dim", "embedding_dim", "intermediate_dim", "num_attention_heads",
            "patch_size", "num_encoder_layers", "num_global_patches", "num_local_patches")


def build_encoder(arch: str, encoder_cfg: dict):
    """Instantiate a backbone module + its feature dim from the YAML
    `encoder` block (config style for `vit`, kwargs style for the ResNets,
    as the JAX registry builds them). Keys meant for other backbones are
    ignored by the ResNets, as in the JAX registry; compute dtype comes from
    the algorithm's autocast."""
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not yet ported to ssv_tpu_torch "
            f"(ROADMAP slice {NOT_PORTED[arch]})")
    if arch == "vit":
        cfg = dict(encoder_cfg or {})
        model = vit.TransformerEncoder(
            **{k: int(cfg[k]) for k in VIT_KEYS},
            seq_pad_multiple=int(cfg.get("seq_pad_multiple", 0)),
            fuse_qkv=bool(cfg.get("fuse_qkv", False)))
        return model, int(cfg["hidden_dim"])
    if arch not in NETWORKS:
        raise ValueError(f"Unknown arch {arch!r}; expected one of {list(NETWORKS)}")
    allowed = {"reduce_bottom_conv", "zero_init_residual"}
    cfg = {k: v for k, v in dict(encoder_cfg or {}).items() if k in allowed}
    entry = NETWORKS[arch]
    return entry["net"](**cfg), entry["dim"]
