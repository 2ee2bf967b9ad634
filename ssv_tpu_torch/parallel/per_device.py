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
    coalesced buffer and divides by the world size.

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
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch import nn

from .mesh import rank, world_size

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


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sums `t` over the ranks, in place."""
    t0 = time.perf_counter()
    dist.all_reduce(t)
    collectives.add(t, t0)
    return t


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    t0 = time.perf_counter()
    parts = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x)
    out = torch.cat(parts)
    collectives.add(out, t0)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return _all_gather(x.contiguous())

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce(grad.contiguous().clone())
        r = rank()
        return grad[r * ctx.rows:(r + 1) * ctx.rows]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone())


def pgather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `x`, in rank order (the identity at world 1)."""
    return x if world_size() == 1 else _Gather.apply(x)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable (the sync BN's
    statistics; the identity at world 1)."""
    return x if world_size() == 1 else _AllReduceSum.apply(x)


@torch.no_grad()
def pmean(x: torch.Tensor) -> torch.Tensor:
    """The replica mean of `x`, without a gradient (x itself at world 1)."""
    w = world_size()
    if w == 1:
        return x.detach()
    return _all_reduce(x.detach().clone()).div_(w)


def _coalesced_mean_(tensors: list[torch.Tensor]) -> None:
    """Replaces each tensor by its replica mean, in one all-reduce."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(flat).div_(world_size())
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])


@torch.no_grad()
def pmean_bn_(*modules: nn.Module) -> None:
    """Replica-means the running mean and variance of every BatchNorm in
    `modules`, in place, so the saved state is the same on every rank."""
    if world_size() == 1:
        return
    stats = [t for m in modules for bn in m.modules()
             if isinstance(bn, nn.modules.batchnorm._BatchNorm)
             for t in (bn.running_mean, bn.running_var)]
    _coalesced_mean_(stats)


@torch.no_grad()
def reduce_grads(params, loss_scope: str) -> None:
    """Replaces each parameter's gradient by the mean of the ranks'
    gradients (the module docstring derives the mean for both scopes)."""
    if loss_scope not in LOSS_SCOPES:
        raise ValueError(f"loss_scope must be one of {LOSS_SCOPES}, got {loss_scope!r}")
    if world_size() == 1:
        return
    _coalesced_mean_([p.grad for p in params if p.grad is not None])
