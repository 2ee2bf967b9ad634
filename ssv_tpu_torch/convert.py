"""Convert the JAX package's flax variables into the port's `state_dict`.

Takes `params` and `batch_stats` as nested dicts of numpy arrays (the
caller turns JAX arrays into numpy) for a `Tower(encoder=ResNet, proj=MLPHead)`
or a bare `ResNet`, and returns a dict of torch tensors keyed by the port's
module names:

  * Conv kernels go from HWIO to OIHW; Dense kernels are transposed;
  * BN `scale`/`bias`/`mean`/`var` -> `weight`/`bias`/`running_mean`/`running_var`;
  * flax auto-names map to the port's names: `Conv_0`/`BatchNorm_0` of the
    ResNet -> `conv1`/`bn1`; `BasicBlock_<k>` -> `layer<s>.<b>` (k counts
    blocks across stages); in a block `Conv_0`, `Conv_1`, `Conv_2` ->
    `conv1`, `conv2`, `downsample.0` and `BatchNorm_<n>` likewise;
    `Dense_<i>` -> `fc.<i>`, and the head's n-th BatchNorm -> `bn.<i>` of
    the n-th layer in `bn_after`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_BLOCK_CONV = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "downsample.0"}
_BLOCK_BN = {"BatchNorm_0": "bn1", "BatchNorm_1": "bn2", "BatchNorm_2": "downsample.1"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _bn(out: dict, prefix: str, params: dict, stats: dict):
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])


def _conv(out: dict, prefix: str, params: dict):
    out[f"{prefix}.weight"] = _t(params["kernel"]).permute(3, 2, 0, 1).contiguous()


def resnet_state_dict(params: dict, batch_stats: dict, stage_sizes: Sequence[int],
                      prefix: str = "") -> dict:
    """flax ResNet variables -> port ResNet state_dict entries."""
    out: dict = {}
    blocks = [(s, b) for s, n in enumerate(stage_sizes) for b in range(n)]
    for name, sub in params.items():
        if name == "Conv_0":
            _conv(out, f"{prefix}conv1", sub)
        elif name == "BatchNorm_0":
            _bn(out, f"{prefix}bn1", sub, batch_stats[name])
        elif name.startswith("BasicBlock_"):
            s, b = blocks[int(name.split("_")[1])]
            base = f"{prefix}layer{s + 1}.{b}."
            for inner, p in sub.items():
                if inner in _BLOCK_CONV:
                    _conv(out, base + _BLOCK_CONV[inner], p)
                elif inner in _BLOCK_BN:
                    _bn(out, base + _BLOCK_BN[inner], p, batch_stats[name][inner])
                else:
                    raise KeyError(f"unexpected flax block variable {name}/{inner}")
        else:
            raise KeyError(f"unexpected flax ResNet variable {name}")
    return out


def mlp_state_dict(params: dict, batch_stats: dict, bn_after: Sequence[int],
                   prefix: str = "") -> dict:
    """flax MLPHead variables -> port MLPHead state_dict entries."""
    out: dict = {}
    for name, sub in params.items():
        kind, idx = name.rsplit("_", 1)
        if kind == "Dense":
            out[f"{prefix}fc.{idx}.weight"] = _t(sub["kernel"]).T.contiguous()
            out[f"{prefix}fc.{idx}.bias"] = _t(sub["bias"])
        elif kind == "BatchNorm":
            _bn(out, f"{prefix}bn.{bn_after[int(idx)]}", sub, batch_stats[name])
        else:
            raise KeyError(f"unexpected flax head variable {name}")
    return out


def tower_state_dict(params: dict, batch_stats: dict, stage_sizes: Sequence[int],
                     bn_after: Sequence[int] = (0, 1)) -> dict:
    """flax Tower(encoder, proj) variables -> port Tower state_dict."""
    out = resnet_state_dict(params["encoder"], batch_stats["encoder"],
                            stage_sizes, prefix="encoder.")
    if "proj" in params:
        out.update(mlp_state_dict(params["proj"], batch_stats["proj"], bn_after,
                                  prefix="proj."))
    return out
