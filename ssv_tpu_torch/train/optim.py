"""Optimizers from the reference YAML schema (port of ssv_tpu/train/optim.py).

`sgd` is momentum 0.9 with Nesterov and coupled weight decay on every
parameter, BN included (the reference hardcodes momentum and Nesterov,
ignoring the config keys). The learning rate is set every step by a
`LambdaLR` whose base is 1, so the lr of step s is exactly `lr_fn(s)`;
stepping it after each `optimizer.step()` evaluates the schedule at a count
that starts from 0, as optax does.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def get_optimizer(cfg: dict, params: Iterable[torch.nn.Parameter],
                  lr_fn: Callable[[int], float]):
    """Returns (optimizer, per-step scheduler)."""
    name = cfg.get("name", "sgd")
    wd = float(cfg.get("weight_decay", 1e-6))
    if name != "sgd":
        raise NotImplementedError(
            f"optimizer {name!r} is not yet ported to ssv_tpu_torch "
            f"(ROADMAP slice B, with DINO)")
    opt = torch.optim.SGD(params, lr=1.0, momentum=0.9, nesterov=True,
                          weight_decay=wd)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_fn)
