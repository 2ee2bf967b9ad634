"""Backbone registry (port of ssv_tpu/models/registry.py)."""

from __future__ import annotations

import torch

from . import resnet, vit

NETWORKS = {
    "resnet18": {"net": resnet.resnet18, "dim": 512},
    "resnet34": {"net": resnet.resnet34, "dim": 512},
}

# archs of the JAX package that the port does not build yet
NOT_PORTED = {"tiny": "C", "resnet50": "C", "resnet101": "C", "resnet152": "C",
              "resnext50": "C", "resnext101": "C", "wide_resnet50": "C",
              "wide_resnet101": "C"}

# the encoder's compute dtype by its config name; parameters stay float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

VIT_KEYS = ("hidden_dim", "embedding_dim", "intermediate_dim", "num_attention_heads",
            "patch_size", "num_encoder_layers", "num_global_patches", "num_local_patches")


def build_encoder(arch: str, encoder_cfg: dict):
    """Instantiate a backbone module + its feature dim from the YAML
    `encoder` block (config style for `vit`, kwargs style for the ResNets,
    as the JAX registry builds them). Keys meant for other backbones are
    ignored by the ResNets, as in the JAX registry. `dtype` (float32 or
    bfloat16) fixes the encoder's compute dtype; without it the caller's
    autocast decides. `param_dtype` may only be float32."""
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not yet ported to ssv_tpu_torch "
            f"(ROADMAP slice {NOT_PORTED[arch]})")
    cfg = dict(encoder_cfg or {})
    dtype = _compute_dtype(cfg)
    if arch == "vit":
        model = vit.TransformerEncoder(
            **{k: int(cfg[k]) for k in VIT_KEYS},
            seq_pad_multiple=int(cfg.get("seq_pad_multiple", 0)),
            fuse_qkv=bool(cfg.get("fuse_qkv", False)), dtype=dtype)
        return model, int(cfg["hidden_dim"])
    if arch not in NETWORKS:
        raise ValueError(f"Unknown arch {arch!r}; expected one of {list(NETWORKS)}")
    allowed = {"reduce_bottom_conv", "zero_init_residual"}
    kwargs = {k: v for k, v in cfg.items() if k in allowed}
    entry = NETWORKS[arch]
    return entry["net"](**kwargs, dtype=dtype), entry["dim"]


def _compute_dtype(cfg: dict) -> torch.dtype | None:
    param_dtype = cfg.get("param_dtype", "float32")
    if param_dtype != "float32":
        raise ValueError(f"encoder param_dtype must be float32, got {param_dtype!r}")
    dtype = cfg.get("dtype")
    if dtype is not None and dtype not in DTYPES:
        raise ValueError(f"encoder dtype must be one of {list(DTYPES)}, got {dtype!r}")
    return DTYPES.get(dtype)
