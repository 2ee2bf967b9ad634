"""Projection heads and prototype tables (port of ssv_tpu/models/heads.py:
the MLP heads of SimCLR, BYOL and ReLIC, SimSiam, Barlow Twins and SwAV,
MoCo's linear head, DINO's weight-normed head, SwAV's prototypes and SeLA's
cluster heads), and the float32 Dense of PIRL's and DeepCluster's heads.

The head's Linear layers run in the caller's autocast dtype (bf16 on the
card) with f32 params; each BatchNorm takes and returns float32, and the
head's output is float32, as in the flax head. `Prototypes`,
`ClusterHeads`, `Float32Dense` and `WeightNormDense` (with the L2
normalisation before it in `DinoHead`) are float32 throughout, as their
flax modules are.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..objectives.losses import l2_normalize
from .resnet import BatchNorm1d


def _lecun_trunc_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's lecun normal: truncated at 2 std, the std corrected for the
    truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


ACTS = {"relu": F.relu, "gelu": F.gelu}   # flax's gelu is the exact one here


def _dense(fc: nn.Linear, x):
    """fc(x) as flax's Dense computes it: the product rounded to its dtype
    (the autocast dtype under autocast), then the bias added in that dtype."""
    y = F.linear(x, fc.weight)
    return y + fc.bias.to(y.dtype)


class MLPHead(nn.Module):
    """MLP head driven by a layer spec: `widths` of the Linear layers,
    `bn_after` the (0-indexed) layers followed by BatchNorm, `act` ("relu" or
    the exact "gelu") between layers and none after the last; `l2_norm_out`
    L2-normalizes the output."""

    def __init__(self, in_dim: int, widths: Sequence[int],
                 bn_after: Sequence[int] = (), l2_norm_out: bool = False,
                 act: str = "relu"):
        super().__init__()
        self.l2_norm_out = l2_norm_out
        self.act = ACTS[act]
        dims = [in_dim, *widths]
        self.fc = nn.ModuleList(nn.Linear(dims[i], dims[i + 1])
                                for i in range(len(widths)))
        self.bn = nn.ModuleDict({str(i): BatchNorm1d(widths[i]) for i in bn_after})

    def forward(self, x):
        for i, fc in enumerate(self.fc):
            x = _dense(fc, x)
            if str(i) in self.bn:
                x = self.bn[str(i)](x.float())
            if i < len(self.fc) - 1:
                x = self.act(x)
        x = x.float()
        return l2_normalize(x) if self.l2_norm_out else x

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax Dense defaults: lecun normal (truncated at 2 std, std
        corrected for the truncation) kernels, zero biases; BN 1 and 0."""
        for fc in self.fc:
            _lecun_trunc_normal_(fc.weight, fc.in_features, generator)
            nn.init.zeros_(fc.bias)
        for bn in self.bn.values():
            nn.init.ones_(bn.weight)
            nn.init.zeros_(bn.bias)


def simclr_projection(input_dim: int, proj_dim: int) -> MLPHead:
    """fc(d,d)-bn-relu-fc(d,p)-bn (no final act)."""
    return MLPHead(input_dim, (input_dim, proj_dim), bn_after=(0, 1))


def byol_mlp(input_dim: int, output_dim: int) -> MLPHead:
    """fc(d,d)-bn-relu-fc(d,p): BYOL's and ReLIC's projector and predictor."""
    return MLPHead(input_dim, (input_dim, output_dim), bn_after=(0,))


def simsiam_projector(input_dim: int, proj_dim: int) -> MLPHead:
    """fc(d,p)-bn-relu-fc(p,p)-bn-relu-fc(p,p)-bn."""
    return MLPHead(input_dim, (proj_dim, proj_dim, proj_dim), bn_after=(0, 1, 2))


def simsiam_predictor(proj_dim: int, bottleneck_dim: int) -> MLPHead:
    """fc(p,b)-bn-relu-fc(b,p)."""
    return MLPHead(proj_dim, (bottleneck_dim, proj_dim), bn_after=(0,))


def barlow_projection(input_dim: int, proj_dim: int) -> MLPHead:
    """fc(d,p)-bn-relu-fc(p,p)-bn-relu-fc(p,p), L2-normalized output."""
    return MLPHead(input_dim, (proj_dim, proj_dim, proj_dim), bn_after=(0, 1),
                   l2_norm_out=True)


def swav_projection(input_dim: int, hidden_dim: int, proj_dim: int) -> MLPHead:
    """fc(d,h)-bn-gelu-fc(h,p)-bn, L2-normalized output."""
    return MLPHead(input_dim, (hidden_dim, proj_dim), bn_after=(0, 1), act="gelu",
                   l2_norm_out=True)


class LinearHead(MLPHead):
    """ReLU then Linear (MoCo's head): bf16 under autocast, float32 out; a
    one-layer `MLPHead` behind the ReLU."""

    def __init__(self, in_dim: int, features: int):
        super().__init__(in_dim, (features,))

    def forward(self, x):
        return super().forward(F.relu(x))


class Float32Dense(nn.Linear):
    """flax's `nn.Dense` without a dtype over float32 features and params:
    float32 whatever the caller's autocast, the product then the bias;
    lecun normal (truncated) kernel, zero bias."""

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            return _dense(self, x.float())

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        _lecun_trunc_normal_(self.weight, self.in_features, generator)
        nn.init.zeros_(self.bias)


class WeightNormDense(nn.Module):
    """A Linear layer with weight normalisation (torch's `weight_norm`,
    dim=0): row j of the weight is g[j] * v[j] / max(||v[j]||, 1e-12), `g`
    starting at ||v[j]||; float32 with autocast off. `v` is stored (out, in),
    as a Linear weight."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.v = nn.Parameter(torch.empty(features, in_dim))
        self.g = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            norm = torch.clamp(torch.linalg.vector_norm(self.v, dim=1), min=1e-12)
            return F.linear(x.float(), self.v * (self.g / norm)[:, None], self.bias)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        _lecun_trunc_normal_(self.v, self.v.shape[1], generator)
        self.g.copy_(torch.linalg.vector_norm(self.v, dim=1))
        nn.init.zeros_(self.bias)


class DinoHead(nn.Module):
    """Three GELU Linear layers of `hidden_dim` (no BN; the caller's autocast
    dtype, float32 out), L2 normalisation, then the weight-normed output
    layer `fc_out` to `proj_dim`, both in float32."""

    def __init__(self, in_dim: int, hidden_dim: int, proj_dim: int):
        super().__init__()
        self.mlp = MLPHead(in_dim, (hidden_dim, hidden_dim, hidden_dim), act="gelu")
        self.fc_out = WeightNormDense(hidden_dim, proj_dim)

    def forward(self, x):
        return self.fc_out(l2_normalize(self.mlp(x)))

    def init_weights(self, generator: torch.Generator):
        self.mlp.init_weights(generator)
        self.fc_out.init_weights(generator)


class Prototypes(nn.Module):
    """A (count, dim) table drawn N(0, 1), its rows L2-normalized on read;
    trained with the model.

    Sharded over `shards` model ranks (the JAX dry run's `P("model", None)`),
    shard m holds rows [m count / shards, (m + 1) count / shards): it draws
    the whole table from the generator, as one process does, and keeps its
    rows, so the shards stacked are the one-process table bit for bit and
    the generator's later draws are the same. The row normalisation is
    local to a shard."""

    def __init__(self, count: int, dim: int, shards: int = 1, shard: int = 0):
        super().__init__()
        if count % shards:
            raise ValueError(f"{count} prototypes do not split over {shards} model ranks")
        rows = count // shards
        self.count, self.rows = count, slice(shard * rows, (shard + 1) * rows)
        self.table = nn.Parameter(torch.empty(rows, dim))

    def forward(self):
        return l2_normalize(self.table)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        table = torch.empty(self.count, self.table.shape[1])
        nn.init.normal_(table, 0.0, 1.0, generator=generator)
        self.table.copy_(table[self.rows])


class ClusterHeads(nn.Module):
    """`heads` parallel linear heads of `clusters` outputs over the features,
    as one batched product over a stacked (heads, dim, clusters) kernel:
    (batch, dim) -> (heads, batch, clusters) logits, in float32 with
    autocast off, as the flax module takes float32 features and params."""

    def __init__(self, dim: int, num_heads: int, num_clusters: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(num_heads, dim, num_clusters))
        self.bias = nn.Parameter(torch.empty(num_heads, num_clusters))

    def forward(self, features):
        with torch.autocast(features.device.type, enabled=False):
            return (torch.einsum("bd,hdk->hbk", features.float(), self.kernel)
                    + self.bias[:, None, :])

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's lecun normal over the (heads, dim, clusters) shape counts
        heads x dim inputs (the heads axis is a receptive field to it)."""
        heads, dim, _ = self.kernel.shape
        _lecun_trunc_normal_(self.kernel, heads * dim, generator)
        nn.init.zeros_(self.bias)
