"""The collectives of a data-parallel step (counterpart of
ssv_tpu/parallel/per_device.py), and the gradient reduction.

Every rank runs the algorithm's step on its slice of the global batch. The
JAX package reaches the same step two ways: jit over the sharded global
batch, where XLA makes every batch statistic global (sync BN), or
`shard_map` with explicit collectives under `per_device_bn: true`. The port
takes the explicit route on both paths; the sync path adds the
differentiable all-reduce inside each BatchNorm (`models/resnet.py`).

  * `pgather(x)` gathers every rank's rows, in rank order, and carries
    gradients: its backward sums the ranks' output gradients and gives each
    rank its own rows (a reduce-scatter);
  * `pmean(x)` is the replica mean of a value (no gradient): the loss
    metric, SeLA's per-head losses, DINO's teacher mean;
  * `pmean_bn_(modules)` replica-means the BatchNorm running statistics in
    place (`per_device_bn`, JAX's `pmean_tree(batch_stats)`);
  * `reduce_grads(params, loss_scope)` all-reduces the gradients in one
    coalesced buffer and divides by the group's size.

Each of these takes a `group` and defaults to the rank's data group
(`mesh.data_group()`), which is the whole world at M = 1. The model axis
(SwAV's prototype table sharded over the model group, `objectives/losses.py`)
adds three pieces, each the identity on a group of one:

  * `copy_to_group(x, group)`: x as it is (the same on every rank of the
    group), whose backward sums the ranks' gradients;
  * `group_sum(x, group)`: the sum of per-shard partials, whose backward
    hands each shard the upstream gradient once;
  * `group_logsumexp(x, dim, group)`: a logsumexp over a dimension split
    across the group (an all-reduce max, then an all-reduce sum of
    exp(x - max)), for each rank's own shard: its backward sums the ranks'
    gradients.

The gradient rule. Every collective's backward here is a sum over ranks,
so when each rank r back-propagates its own loss L_r, the gradient that
reaches rank r's replica is that of sum_r' L_r' through rank r's inputs;
the sum of the ranks' gradients is the gradient of sum_r L_r, and their
mean that of (1/W) sum_r L_r. For `loss_scope="local"` (a per-sample mean
over the rank's slice) that is the mean over the global batch; for
`"global"` (one loss from gathered rows, the same on every rank) it is
that loss. So both scopes take the mean. JAX's `psum` for a global loss
differs because its `all_gather` transpose hands each replica only its
own share of the cotangent, not the sum over replicas.

Across the model group every rank of a row computes the same loss from
its own shard, and what a value's backward must do depends on how the
ranks use it. A sum of shards' partials that every rank then uses the same
way (the loss, `group_sum`) already holds the whole loss's gradient on each
rank, so its backward must not sum again (that would multiply the gradient
by M). A value that every rank uses with its own shard (z fed to each
shard's scores, `copy_to_group`; the logsumexp over K inside each shard's
log-softmax, `group_logsumexp`) gets only its shard's share of the
gradient on each rank, so its backward sums them. Then each rank's
gradients are those of the one-process loss times its data group's
factor, and `reduce_grads` over the data group gives the single-process
gradient, for the replicated tower and for each shard alike. SwAV reduces
the tower's over the world (its mean is the data group's, and it makes the
model ranks' copies equal bit for bit, `train/algorithms/swav.py`).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch import nn

from . import mesh

LOSS_SCOPES = ("global", "local")


class _Counts:
    """Collective calls, the bytes they carry and the host seconds they take
    (blocking on gloo; the enqueue alone on NCCL), for step_profile."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    def add(self, t: torch.Tensor, t0: float):
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        self.seconds += time.perf_counter() - t0


collectives = _Counts()


def _data(group):
    """`group`, or the rank's data group where it is None."""
    return mesh.data_group() if group is None else group


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduces `t` over `group` (None: the world), in place."""
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op, group=group)
    collectives.add(t, t0)
    return t


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    t0 = time.perf_counter()
    parts = [torch.empty_like(x) for _ in range(mesh.group_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts)
    collectives.add(out, t0)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rows, ctx.group = x.shape[0], group
        return _all_gather(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce(grad.contiguous().clone(), ctx.group)
        r = mesh.group_rank(ctx.group)
        return grad[r * ctx.rows:(r + 1) * ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), ctx.group), None


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def pgather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of `x`, in the group's rank order (the identity on
    a group of one)."""
    group = _data(group)
    return x if mesh.group_size(group) == 1 else _Gather.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the group, differentiable (the sync BN's
    statistics; the identity on a group of one)."""
    group = _data(group)
    return x if mesh.group_size(group) == 1 else _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """`x`, the same on every rank of `group`, fed to each rank's shard: its
    backward sums the ranks' gradients."""
    return x if mesh.group_size(group) == 1 else _CopyToGroup.apply(x, group)


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of each rank's partial `x`: its backward hands
    each rank the upstream gradient as it is."""
    return x if mesh.group_size(group) == 1 else _GroupSum.apply(x, group)


def group_logsumexp(x: torch.Tensor, dim: int, group, keepdim: bool = False) -> torch.Tensor:
    """logsumexp over `dim`, whose entries are split across `group`: an
    all-reduce max (a constant to autograd), then a differentiable
    all-reduce sum of exp(x - max), whose backward sums the ranks'
    gradients, since each rank subtracts the result from its own shard."""
    with torch.no_grad():
        top = x.amax(dim, keepdim=True)
        if mesh.group_size(group) > 1:
            _all_reduce(top, group, dist.ReduceOp.MAX)
    out = top + all_reduce_sum((x - top).exp().sum(dim, keepdim=True), group).log()
    return out if keepdim else out.squeeze(dim)


@torch.no_grad()
def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of `x` over the group, without a gradient (x itself on a
    group of one)."""
    group = _data(group)
    w = mesh.group_size(group)
    if w == 1:
        return x.detach()
    return _all_reduce(x.detach().clone(), group).div_(w)


def _coalesced_mean_(tensors: list[torch.Tensor], group) -> None:
    """Replaces each tensor by its mean over `group`, in one all-reduce."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(flat, group).div_(mesh.group_size(group))
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])


@torch.no_grad()
def pmean_bn_(*modules: nn.Module, group=None) -> None:
    """Means the running mean and variance of every BatchNorm in `modules`
    over the group, in place, so the saved state is the same on every
    rank."""
    group = _data(group)
    if mesh.group_size(group) == 1:
        return
    stats = [t for m in modules for bn in m.modules()
             if isinstance(bn, nn.modules.batchnorm._BatchNorm)
             for t in (bn.running_mean, bn.running_var)]
    _coalesced_mean_(stats, group)


@torch.no_grad()
def reduce_grads(params, loss_scope: str, group=None) -> None:
    """Replaces each parameter's gradient by the mean of the group's
    gradients (the module docstring derives the mean for both scopes, and
    for a shard of the model axis)."""
    if loss_scope not in LOSS_SCOPES:
        raise ValueError(f"loss_scope must be one of {LOSS_SCOPES}, got {loss_scope!r}")
    group = _data(group)
    if mesh.group_size(group) == 1:
        return
    _coalesced_mean_([p.grad for p in params if p.grad is not None], group)
