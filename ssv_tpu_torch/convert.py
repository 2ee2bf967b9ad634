"""Convert the JAX package's flax variables into the port's `state_dict`.

Takes `params` and `batch_stats` as nested dicts of numpy arrays (the
caller turns JAX arrays into numpy) for a `Tower(encoder=ResNet or
TransformerEncoder, proj=MLPHead or DinoHead, pred=MLPHead)` or a bare
`ResNet`, and returns a dict of torch tensors keyed by the port's module
names:

  * Conv kernels go from HWIO to OIHW; Dense kernels are transposed;
  * BN `scale`/`bias`/`mean`/`var` -> `weight`/`bias`/`running_mean`/`running_var`;
  * flax auto-names map to the port's names: `Conv_<i>`/`BatchNorm_<i>` of
    the ResNet (its stem, i = 0) or the `TinyEncoder` (i = 0, 1; kernel and
    bias) -> `conv<i+1>`/`bn<i+1>`; `BasicBlock_<k>` or `Bottleneck_<k>` ->
    `layer<s>.<b>` (k counts blocks across stages); in a block of n convs
    (2 or 3) `Conv_<i>` -> `conv<i+1>` for i < n and `Conv_<n>` ->
    `downsample.0`, and `BatchNorm_<i>` likewise (grouped kernels take the
    same HWIO -> OIHW permute);
    `Dense_<i>` -> `fc.<i>`, and the head's n-th BatchNorm -> `bn.<i>` of
    the n-th layer in that head's `bn_after`;
  * the ViT: `cls_embedding` and both position tables as they are,
    `projection_fc` (its kernel's rows (c, py, px) then position) ->
    the Linear `projection_fc`, `layer_<i>` -> `layers.<i>` with
    `attention/{ln,query,key,value}` and `feedfwd/{ln,Dense_0,Dense_1}`
    (LayerNorm `scale` -> `weight`; Dense_<i> -> `fc.<i>`);
  * the `DinoHead`: `MLPHead_0/Dense_<i>` -> `mlp.fc.<i>`, `fc_out/{v,g,bias}`
    -> `fc_out.{v (transposed), g, bias}`.

`model_state_dict` takes any algorithm's model: a Tower; SwAV's
`{"model": Tower, "prototypes": {"table"}}` -> `tower.*` and
`prototypes.table`; SeLA's `SelaNet` (`encoder`, `cluster_heads` with its
(heads, dim, clusters) kernel, kept in that layout) -> `encoder.*` and
`cluster_heads.*`; an encoder beside named Dense layers (PIRL's `PirlNet`:
`f_proj`, `g_proj_head_initial`, `g_proj_head_final`; DeepCluster's
`DCNet`: `clf_head`) -> `encoder.*` and `<name>.weight`/`.bias`.

Under a model axis of M ranks (`parallel/mesh.py`), `prototype_shard`
gives model rank m its rows of SwAV's `prototypes/table`, as the port's
sharded `Prototypes` holds them, and `gather_prototypes` stacks the shards
back into the one table.

`extra_state_dicts` maps the rest of a JAX `TrainState.extra` to the
port's `state.extra` modules: an EMA target (`target_params` /
`target_batch_stats`) or MoCo's key tower (`key_params` / `key_batch_stats`)
-> `target`; DINO's teacher (`teacher_params` / `teacher_batch_stats`) ->
`teacher` and its `center` -> `value` of `center`; a `RingBuffer` (MoCo's
`queue`, SwAV's `bank`) -> `data` and `ptr` of the module of the same
name, PIRL's `SampleBank` `bank` -> `data` of `bank`; SeLA's `alpha`,
`beta`, `pseudo_labels` and `best_head` -> the buffers of `self_label`;
DeepCluster's `pseudo_labels` alone -> `labels` of `pseudo_labels`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_BLOCK_CONVS = {"BasicBlock": 2, "Bottleneck": 3}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _bn(out: dict, prefix: str, params: dict, stats: dict):
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])


def _conv(out: dict, prefix: str, params: dict):
    out[f"{prefix}.weight"] = _t(params["kernel"]).permute(3, 2, 0, 1).contiguous()
    if "bias" in params:
        out[f"{prefix}.bias"] = _t(params["bias"])


def _dense(out: dict, prefix: str, params: dict):
    out[f"{prefix}.weight"] = _t(params["kernel"]).T.contiguous()
    if "bias" in params:
        out[f"{prefix}.bias"] = _t(params["bias"])


def _layer_norm(out: dict, prefix: str, params: dict):
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])


def resnet_state_dict(params: dict, batch_stats: dict, stage_sizes: Sequence[int],
                      prefix: str = "") -> dict:
    """flax ResNet (BasicBlock or Bottleneck, by the block names) or
    TinyEncoder variables -> port state_dict entries."""
    out: dict = {}
    blocks = [(s, b) for s, n in enumerate(stage_sizes) for b in range(n)]
    for name, sub in params.items():
        kind, _, idx = name.rpartition("_")
        if kind == "Conv":
            _conv(out, f"{prefix}conv{int(idx) + 1}", sub)
        elif kind == "BatchNorm":
            _bn(out, f"{prefix}bn{int(idx) + 1}", sub, batch_stats[name])
        elif kind in _BLOCK_CONVS:
            s, b = blocks[int(idx)]
            base = f"{prefix}layer{s + 1}.{b}."
            n = _BLOCK_CONVS[kind]
            for inner, p in sub.items():
                layer, _, i = inner.rpartition("_")
                if layer not in ("Conv", "BatchNorm"):
                    raise KeyError(f"unexpected flax block variable {name}/{inner}")
                i = int(i)
                if layer == "Conv":
                    _conv(out, base + (f"conv{i + 1}" if i < n else "downsample.0"), p)
                else:
                    _bn(out, base + (f"bn{i + 1}" if i < n else "downsample.1"), p,
                        batch_stats[name][inner])
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
            _dense(out, f"{prefix}fc.{idx}", sub)
        elif kind == "BatchNorm":
            _bn(out, f"{prefix}bn.{bn_after[int(idx)]}", sub, batch_stats[name])
        else:
            raise KeyError(f"unexpected flax head variable {name}")
    return out


_VIT_DENSE = {"query": "query", "key": "key", "value": "value",
              "Dense_0": "fc.0", "Dense_1": "fc.1"}


def vit_state_dict(params: dict, prefix: str = "") -> dict:
    """flax TransformerEncoder params -> port TransformerEncoder state_dict
    entries."""
    out: dict = {}
    for name, sub in params.items():
        if name in ("cls_embedding", "pos_embedding_global", "pos_embedding_local"):
            out[f"{prefix}{name}"] = _t(sub)
        elif name == "projection_fc":
            _dense(out, f"{prefix}projection_fc", sub)
        elif name.startswith("layer_"):
            base = f"{prefix}layers.{name.split('_')[1]}."
            for part, layer in sub.items():             # attention, feedfwd
                for inner, p in layer.items():
                    if inner == "ln":
                        _layer_norm(out, f"{base}{part}.ln", p)
                    elif inner in _VIT_DENSE:
                        _dense(out, f"{base}{part}.{_VIT_DENSE[inner]}", p)
                    else:
                        raise KeyError(f"unexpected flax ViT variable {name}/{part}/{inner}")
        else:
            raise KeyError(f"unexpected flax ViT variable {name}")
    return out


def dino_head_state_dict(params: dict, prefix: str = "") -> dict:
    """flax DinoHead params -> port DinoHead state_dict entries."""
    if set(params) != {"MLPHead_0", "fc_out"}:
        raise KeyError(f"unexpected flax DinoHead variables {sorted(params)}")
    out = mlp_state_dict(params["MLPHead_0"], {}, (), prefix=f"{prefix}mlp.")
    fc = params["fc_out"]
    out[f"{prefix}fc_out.v"] = _t(fc["v"]).T.contiguous()
    out[f"{prefix}fc_out.g"] = _t(fc["g"])
    out[f"{prefix}fc_out.bias"] = _t(fc["bias"])
    return out


def _encoder_state_dict(params: dict, batch_stats: dict, stage_sizes: Sequence[int]) -> dict:
    """The `encoder` of a flax model, a ResNet or a ViT (by its variables)."""
    if "cls_embedding" in params["encoder"]:
        return vit_state_dict(params["encoder"], prefix="encoder.")
    return resnet_state_dict(params["encoder"], batch_stats["encoder"], stage_sizes,
                             prefix="encoder.")


def tower_state_dict(params: dict, batch_stats: dict, stage_sizes: Sequence[int],
                     bn_after: dict[str, Sequence[int]]) -> dict:
    """flax Tower(encoder, proj, pred) variables -> port Tower state_dict;
    the encoder a ResNet or a ViT (by its variables); `bn_after` gives each
    head of the tower (`proj`, `pred`) its layers followed by BatchNorm (a
    DinoHead has none)."""
    out = _encoder_state_dict(params, batch_stats, stage_sizes)
    heads = set(params) - {"encoder"}
    if heads != set(bn_after):
        raise KeyError(f"flax tower heads {sorted(heads)}, bn_after given for "
                       f"{sorted(bn_after)}")
    for head, layers in bn_after.items():
        if "fc_out" in params[head]:
            out.update(dino_head_state_dict(params[head], prefix=f"{head}."))
        else:
            out.update(mlp_state_dict(params[head], batch_stats.get(head, {}), layers,
                                      prefix=f"{head}."))
    return out


def model_state_dict(params: dict, batch_stats: dict, stage_sizes: Sequence[int],
                     bn_after: dict[str, Sequence[int]]) -> dict:
    """Any algorithm's flax model variables -> the port's model state_dict."""
    if set(params) == {"model", "prototypes"}:             # SwAV
        out = {f"tower.{k}": v for k, v in tower_state_dict(
            params["model"], batch_stats, stage_sizes, bn_after).items()}
        out["prototypes.table"] = _t(params["prototypes"]["table"])
        return out
    if "cluster_heads" in params:                           # SeLA
        out = resnet_state_dict(params["encoder"], batch_stats["encoder"],
                                stage_sizes, prefix="encoder.")
        out["cluster_heads.kernel"] = _t(params["cluster_heads"]["kernel"])
        out["cluster_heads.bias"] = _t(params["cluster_heads"]["bias"])
        return out
    dense = set(params) - {"encoder"}
    if all("kernel" in params[name] for name in dense):      # PirlNet, DCNet
        out = _encoder_state_dict(params, batch_stats, stage_sizes)
        for name in dense:
            _dense(out, name, params[name])
        return out
    return tower_state_dict(params, batch_stats, stage_sizes, bn_after)


def prototype_shard(table, shard: int, shards: int) -> np.ndarray:
    """Rows [m K / M, (m + 1) K / M) of a (K, d) prototype table (numpy),
    model rank m's of M; M must divide K."""
    table = np.asarray(table)
    k = table.shape[0]
    if k % shards:
        raise ValueError(f"{k} prototypes do not split over {shards} model ranks")
    rows = k // shards
    return table[shard * rows:(shard + 1) * rows]


def gather_prototypes(shards) -> np.ndarray:
    """The (K, d) table from the model ranks' shards, in model-rank order."""
    return np.concatenate([np.asarray(s) for s in shards])


def extra_state_dicts(extra: dict, stage_sizes: Sequence[int],
                      bn_after: dict[str, Sequence[int]]) -> dict:
    """A JAX `TrainState.extra` -> the port's `{module name: state_dict}`;
    an empty `extra` -> {}. `bn_after` describes the target tower's heads."""
    out: dict = {}
    done = set()
    for prefix, name in (("target", "target"), ("key", "target"), ("teacher", "teacher")):
        if f"{prefix}_params" in extra:
            out[name] = tower_state_dict(extra[f"{prefix}_params"],
                                         extra[f"{prefix}_batch_stats"],
                                         stage_sizes, bn_after)
            done |= {f"{prefix}_params", f"{prefix}_batch_stats"}
    if "center" in extra:
        out["center"] = {"value": _t(extra["center"])}
        done.add("center")
    for name in ("queue", "bank"):
        if name in extra:
            buf = extra[name]
            if hasattr(buf, "ptr"):                 # a RingBuffer (data, ptr)
                out[name] = {"data": _t(buf.data), "ptr": torch.tensor(int(buf.ptr))}
            else:                                   # PIRL's SampleBank (data,)
                out[name] = {"data": _t(buf.data)}
            done.add(name)
    if "pseudo_labels" in extra and "alpha" not in extra:     # DeepCluster
        out["pseudo_labels"] = {
            "labels": torch.from_numpy(np.array(extra["pseudo_labels"], np.int64))}
        done.add("pseudo_labels")
    elif "pseudo_labels" in extra:                            # SeLA
        out["self_label"] = {
            "alpha": _t(extra["alpha"]), "beta": _t(extra["beta"]),
            "pseudo_labels": torch.from_numpy(np.array(extra["pseudo_labels"], np.int64)),
            "best_head": torch.tensor(int(extra["best_head"]))}
        done |= {"alpha", "beta", "pseudo_labels", "best_head"}
    if set(extra) - done:
        raise KeyError(f"unexpected JAX extra state {sorted(set(extra) - done)}")
    return out
