"""Optimizers from the reference YAML schema (port of ssv_tpu/train/optim.py).

`sgd` is torch's SGD, momentum 0.9 with Nesterov and coupled weight decay
on every parameter, BN included (the reference hardcodes momentum and
Nesterov, ignoring the config keys). `adam` and `adamw` are `OptaxAdam`,
which takes `lr`, `epsilon` and `weight_decay`; the decay is coupled (into
the gradient) for `sgd` and `adam`, decoupled for `adamw`. The learning
rate is set every step by a `LambdaLR` whose base is 1, so the lr of step s
is exactly `lr_fn(s)`; stepping it after each `optimizer.step()` evaluates
the schedule at a count that starts from 0, as optax does.

DINO's extras come in optax's order through a step pre-hook: `grad_clip`
clamps each gradient element to +-clip before the optimizer adds any decay,
and `weight_decay_fn` sets the group's `weight_decay` to wd(count) before
each step, count being the steps taken before it (kept in the param group as
`count`, so checkpoints carry it). A parameter without a gradient is
skipped, as torch's optimizers skip it.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

f32 = np.float32


class OptaxAdam(torch.optim.Optimizer):
    """optax's scale_by_adam (b1 0.9, b2 0.999, `eps`) with coupled decay
    (`adam`: wd p added to the gradient) or decoupled (`adamw`: wd p added
    to Adam's update), then scaled by -lr. torch.optim.Adam/AdamW compute the
    same sum but take the bias corrections 1 - b**t in float64, where optax
    takes them in float32 (0.999 rounds to 1 - 0.99998713e-3, so 1 - b2**t is
    1.3e-5 small relatively): over ten steps their parameters end 1.6e-6 to
    1.8e-6 from optax's, this class's within 1e-6."""

    def __init__(self, params, lr: float = 1.0, eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = False):
        super().__init__(params, dict(lr=lr, eps=eps, weight_decay=weight_decay,
                                      decoupled=decoupled))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            grads = [p.grad for p in params]
            if wd and not group["decoupled"]:
                grads = torch._foreach_add(grads, torch._foreach_mul(params, wd))
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"], st["mu"], st["nu"] = 0, torch.zeros_like(p), torch.zeros_like(p)
                st["step"] += 1
            mus, nus = [st["mu"] for st in states], [st["nu"] for st in states]
            # mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, as optax rounds them
            new_mu = torch._foreach_add(torch._foreach_mul(grads, 0.1), torch._foreach_mul(mus, 0.9))
            sq = torch._foreach_mul(grads, grads)
            new_nu = torch._foreach_add(torch._foreach_mul(sq, 1 - 0.999),
                                        torch._foreach_mul(nus, 0.999))
            torch._foreach_copy_(mus, new_mu)
            torch._foreach_copy_(nus, new_nu)
            # the bias corrections 1 - b**t in float32, as optax takes them
            corr = {t: (float(f32(1) - f32(0.9) ** f32(t)), float(f32(1) - f32(0.999) ** f32(t)))
                    for t in {st["step"] for st in states}}
            denom = torch._foreach_sqrt(
                torch._foreach_div(new_nu, [corr[st["step"]][1] for st in states]))
            torch._foreach_add_(denom, eps)
            updates = torch._foreach_div(
                torch._foreach_div(new_mu, [corr[st["step"]][0] for st in states]), denom)
            if wd and group["decoupled"]:
                torch._foreach_add_(updates, torch._foreach_mul(params, wd))
            torch._foreach_mul_(updates, -lr)
            torch._foreach_add_(params, updates)


def _chain_pre_hook(weight_decay_fn: Optional[Callable[[int], float]],
                    grad_clip: Optional[float]):
    def hook(optimizer, args, kwargs):
        for group in optimizer.param_groups:
            if grad_clip is not None:
                grads = [p.grad for p in group["params"] if p.grad is not None]
                torch._foreach_clamp_min_(grads, -grad_clip)
                torch._foreach_clamp_max_(grads, grad_clip)
            if weight_decay_fn is not None:
                group["weight_decay"] = weight_decay_fn(group["count"])
                group["count"] += 1
    return hook


def get_optimizer(cfg: dict, params: Iterable[torch.nn.Parameter],
                  lr_fn: Callable[[int], float],
                  weight_decay_fn: Optional[Callable[[int], float]] = None,
                  grad_clip: Optional[float] = None):
    """Returns (optimizer, per-step scheduler)."""
    name = cfg.get("name", "sgd")
    wd = float(cfg.get("weight_decay", 1e-6))
    if name == "sgd":
        opt = torch.optim.SGD(params, lr=1.0, momentum=0.9, nesterov=True,
                              weight_decay=wd)
    elif name in ("adam", "adamw"):
        opt = OptaxAdam(params, eps=float(cfg.get("epsilon", 1e-8)), weight_decay=wd,
                        decoupled=name == "adamw")
    else:
        raise ValueError(f"Unknown optimizer {name!r}")
    if weight_decay_fn is not None or grad_clip is not None:
        for group in opt.param_groups:
            group["count"] = 0
        opt.register_step_pre_hook(_chain_pre_hook(
            weight_decay_fn, None if grad_clip is None else float(grad_clip)))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_fn)
