"""Backbone registry (port of ssv_tpu/models/registry.py)."""

from __future__ import annotations

import torch

from . import resnet, vit
from .tiny import TINY_DIM, TinyEncoder

NETWORKS = {
    "tiny": {"net": TinyEncoder, "dim": TINY_DIM},  # test/example backbone
    "resnet18": {"net": resnet.resnet18, "dim": 512},
    "resnet34": {"net": resnet.resnet34, "dim": 512},
    "resnet50": {"net": resnet.resnet50, "dim": 2048},
    "resnet101": {"net": resnet.resnet101, "dim": 2048},
    "resnet152": {"net": resnet.resnet152, "dim": 2048},
    "resnext50": {"net": resnet.resnext50_32x4d, "dim": 2048},
    "resnext101": {"net": resnet.resnext101_32x8d, "dim": 2048},
    "wide_resnet50": {"net": resnet.wide_resnet50_2, "dim": 2048},
    "wide_resnet101": {"net": resnet.wide_resnet101_2, "dim": 2048},
    "vit": {"net": None, "dim": None},  # built from config below
}

# the encoder's compute dtype by its config name; parameters stay float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

VIT_KEYS = ("hidden_dim", "embedding_dim", "intermediate_dim", "num_attention_heads",
            "patch_size", "num_encoder_layers", "num_global_patches", "num_local_patches")


def build_encoder(arch: str, encoder_cfg: dict):
    """Instantiate a backbone module + its feature dim from the YAML
    `encoder` block (config style for `vit`, kwargs style for the ResNets,
    as the JAX registry builds them; `tiny` also takes `features`, its
    width). Keys meant for other backbones are ignored, as in the JAX
    registry. `dtype` (float32 or bfloat16) fixes the encoder's compute
    dtype; without it the caller's autocast decides. `param_dtype` may only
    be float32."""
    if arch not in NETWORKS:
        raise ValueError(f"Unknown arch {arch!r}; expected one of {list(NETWORKS)}")
    cfg = dict(encoder_cfg or {})
    dtype = _compute_dtype(cfg)
    if arch == "vit":
        model = vit.TransformerEncoder(
            **{k: int(cfg[k]) for k in VIT_KEYS},
            seq_pad_multiple=int(cfg.get("seq_pad_multiple", 0)),
            fuse_qkv=bool(cfg.get("fuse_qkv", False)), dtype=dtype)
        return model, int(cfg["hidden_dim"])
    allowed = {"reduce_bottom_conv", "zero_init_residual"}
    if arch == "tiny":
        allowed.add("features")
    kwargs = {k: v for k, v in cfg.items() if k in allowed}
    entry = NETWORKS[arch]
    # flax infers a head's input width; the port's Linear needs `features`
    dim = int(kwargs.get("features", entry["dim"]))
    return entry["net"](**kwargs, dtype=dtype), dim


def _compute_dtype(cfg: dict) -> torch.dtype | None:
    param_dtype = cfg.get("param_dtype", "float32")
    if param_dtype != "float32":
        raise ValueError(f"encoder param_dtype must be float32, got {param_dtype!r}")
    dtype = cfg.get("dtype")
    if dtype is not None and dtype not in DTYPES:
        raise ValueError(f"encoder dtype must be one of {list(DTYPES)}, got {dtype!r}")
    return DTYPES.get(dtype)
