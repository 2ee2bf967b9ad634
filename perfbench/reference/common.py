"""Pieces the reference steps share: the MLP heads, L2 normalisation, the
learning-rate and EMA schedules, SGD with Nesterov momentum and coupled
weight decay, Adam with coupled or decoupled decay and an element clamp,
and the rounding to fp8 that the control runs with. Plain PyTorch,
float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .resnet18 import batch_norm


def mlp_specs(prefix: str, widths: list[int], bn_after: tuple[int, ...]) -> list:
    """fc(widths[0] -> widths[1]) [-bn] -relu- fc(...) ..., named as
    `<prefix>fc.<i>.weight|bias` and `<prefix>bn.<i>.weight|bias`."""
    out = []
    for i in range(len(widths) - 1):
        out += [(f"{prefix}fc.{i}.weight", (widths[i + 1], widths[i]), "linear"),
                (f"{prefix}fc.{i}.bias", (widths[i + 1],), "zero")]
    for i in bn_after:
        out += [(f"{prefix}bn.{i}.weight", (widths[i + 1],), "one"),
                (f"{prefix}bn.{i}.bias", (widths[i + 1],), "zero")]
    return out


def mlp(params: dict, prefix: str, x, layers: int, bn_after: tuple[int, ...], cast):
    for i in range(layers):
        w, b = params[f"{prefix}fc.{i}.weight"], params[f"{prefix}fc.{i}.bias"]
        x = cast(cast(x) @ cast(w).T) + b
        if i in bn_after:
            x = batch_norm(x, params[f"{prefix}bn.{i}.weight"], params[f"{prefix}bn.{i}.bias"],
                           (0,))
        if i < layers - 1:
            x = torch.relu(x)
    return x


def l2_normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def lr_at(step: int, cfg: dict, steps_per_epoch: int) -> float:
    """Linear warm-up from 1e-12 over `warmup_epochs`, then a cosine to 0
    over the run's `epochs` (the shipped `cosine` scheduler)."""
    base = float(cfg["optimizer"]["lr"])
    total = int(cfg["epochs"]) * steps_per_epoch
    warm = int(cfg["scheduler"].get("warmup_epochs", 0)) * steps_per_epoch
    if step < warm:
        return 1e-12 + (base - 1e-12) * step / warm
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return base * 0.5 * (1.0 + math.cos(math.pi * frac))


def cosine_ramp(step: int, total: int, lower: float, upper: float) -> float:
    frac = min(max(step / max(total, 1), 0.0), 1.0)
    return upper - (upper - lower) * (math.cos(math.pi * frac) + 1.0) / 2.0


@torch.no_grad()
def sgd_nesterov(params: dict, grads: dict, bufs: dict, lr: float, cfg: dict) -> None:
    """d = g + wd p; buf = d on the first step, else momentum * buf + d;
    p -= lr (d + momentum * buf). Every parameter decays, BN included."""
    wd = float(cfg["optimizer"].get("weight_decay", 0.0))
    momentum = float(cfg["optimizer"].get("momentum", 0.9))
    for name, g in grads.items():
        p = params[name]
        d = g + wd * p
        bufs[name] = d.clone() if name not in bufs else momentum * bufs[name] + d
        p.sub_(lr * (d + momentum * bufs[name]))


@torch.no_grad()
def adam(params: dict, grads: dict, moments: dict, step: int, lr: float, weight_decay: float,
         decoupled: bool, clip: float | None = None, eps: float = 1e-8,
         betas: tuple[float, float] = (0.9, 0.999)) -> dict:
    """Adam (arXiv:1412.6980) in this order: each gradient element clamped
    to +-clip; the decay wd p added to the gradient where it is coupled
    (`adam`); the moments m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2
    (zero before the first step); the update m / (1 - b1^t) over
    sqrt(v / (1 - b2^t)) + eps, t = step + 1, the corrections in float32;
    wd p added to the update where the decay is decoupled (AdamW,
    arXiv:1711.05101); p -= lr x update. `moments` keeps (m, v) by name.
    Returns the gradients as clamped, before any decay."""
    b1, b2 = betas
    t = np.float32(step + 1)
    c1 = float(np.float32(1) - np.float32(b1) ** t)
    c2 = float(np.float32(1) - np.float32(b2) ** t)
    taken = {}
    for name, g in grads.items():
        p = params[name]
        g = g if clip is None else torch.clamp(g, -clip, clip)
        taken[name] = g
        if not decoupled:
            g = g + weight_decay * p
        m, v = moments.get(name, (torch.zeros_like(p), torch.zeros_like(p)))
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        moments[name] = (m, v)
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if decoupled:
            u = u + weight_decay * p
        p.sub_(lr * u)
    return taken


def _round(x, dtype):
    """x rounded to `dtype` with one scale for the tensor (its largest
    magnitude at the format's largest finite value), back in float32."""
    scale = torch.finfo(dtype).max / torch.clamp(x.detach().abs().max(), min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8(torch.autograd.Function):
    """The forward operand in e4m3, its gradient in e5m2: fp8 training's
    formats."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def fp8(x):
    return _Fp8.apply(x)


def identity(x):
    return x


CASTS = {"float32": identity, "fp8": fp8}
