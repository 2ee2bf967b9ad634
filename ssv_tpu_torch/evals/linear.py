"""Linear probe on frozen features (port of ssv_tpu/evals/linear.py).

The JAX package's recipe: a (d, classes) linear layer from weights
normal / sqrt(d) and a zero bias, trained with coupled weight decay and SGD
momentum 0.9 (no Nesterov) on a per-step cosine learning rate with no
warmup, over `epochs` fresh permutations of the train features in batches
(`steps_per_epoch = n // batch`, the batch capped at n), on the mean NLL of
the log-softmax; the result is the argmax accuracy on the test split.

Everything runs in float32 on the features' device. The draws (weights and
the (steps, batch) index matrix) are apart from the loop (`train_probe`), so
the loop can be given another implementation's draws. The loop is eager and
keeps its host work per step small (about 19,500 steps at the shipped
`linear_eval`): the indices are drawn on the device beforehand, the
learning rates computed once, nothing is read back until the accuracy, and
the gradient of the NLL, (softmax - onehot) / batch, and the update of
`torch.optim.SGD(momentum=m, weight_decay=wd)` are written out as a dozen
ops, without autograd or `torch.optim`'s per-step overhead.
"""

from __future__ import annotations

import math

import torch

from ..utils.schedules import warmup_cosine


def _recipe(config: dict):
    cfg = dict(config or {})
    return (int(cfg.get("epochs", 100)), int(cfg.get("batch_size", 256)),
            float(cfg.get("lr", 0.1)), float(cfg.get("momentum", 0.9)),
            float(cfg.get("weight_decay", 1e-6)))


def train_probe(config: dict, x, y, xt, yt, w, b, idx_mat) -> float:
    """Trains the probe from weights `w` (d, classes) and bias `b` over the
    rows of `idx_mat` (one batch of train indices per step) and returns its
    test accuracy."""
    _, _, lr, momentum, wd = _recipe(config)
    params = [w.detach().clone(), b.detach().clone()]
    bufs = [torch.zeros_like(t) for t in params]   # momentum * 0 + g is g
    total, batch = idx_mat.shape
    rows = torch.arange(batch, device=x.device)
    lrs = [warmup_cosine(s, base_lr=lr, total_steps=total, warmup_steps=0)
           for s in range(total)]
    for s in range(total):
        idx = idx_mat[s]
        xb = x[idx]
        g = torch.softmax(xb @ params[0] + params[1], dim=-1)
        g[rows, y[idx]] -= 1.0
        g /= batch
        grads = [xb.T @ g, g.sum(dim=0)]
        torch._foreach_add_(grads, params, alpha=wd)      # coupled weight decay
        torch._foreach_mul_(bufs, momentum)
        torch._foreach_add_(bufs, grads)
        torch._foreach_add_(params, bufs, alpha=-lrs[s])
    pred = (xt @ params[0] + params[1]).argmax(dim=-1)
    return float((pred == yt).float().mean())


def linear_evaluation(config: dict, train_data: dict, test_data: dict,
                      num_classes: int, seed: int = 0) -> float:
    """`train_data`/`test_data` hold `fvecs` (n, d) and `labels` (n,), as
    tensors or arrays; the probe runs on the device of `train_data["fvecs"]`
    (the CPU for arrays)."""
    epochs, batch, _, _, _ = _recipe(config)
    x = torch.as_tensor(train_data["fvecs"]).float()
    dev = x.device
    y = torch.as_tensor(train_data["labels"], device=dev).long()
    xt = torch.as_tensor(test_data["fvecs"], device=dev).float()
    yt = torch.as_tensor(test_data["labels"], device=dev).long()

    n, d = x.shape
    batch = min(batch, n)
    steps_per_epoch = max(n // batch, 1)
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(d, num_classes, generator=g, device=dev) * (1.0 / math.sqrt(d))
    b = torch.zeros(num_classes, device=dev)
    idx_mat = torch.stack([
        torch.randperm(n, generator=g, device=dev)[: steps_per_epoch * batch]
        for _ in range(epochs)]).reshape(epochs * steps_per_epoch, batch)
    return train_probe(config, x, y, xt, yt, w, b, idx_mat)
