"""Optimizers from the reference YAML schema (port of ssv_tpu/train/optim.py).

`sgd` is torch's SGD, momentum 0.9 with Nesterov and coupled weight decay
on every parameter, BN included (the reference hardcodes momentum and
Nesterov, ignoring the config keys), in its fused form: the one that takes
its learning rate as a tensor on the device. `adam` and `adamw` are
`OptaxAdam`, which takes `lr`, `epsilon` and `weight_decay`; the decay is
coupled (into the gradient) for `sgd` and `adam`, decoupled for `adamw`.

Every number a step takes from a schedule comes from the device, as the
JAX package's step reads `state.step` inside its program: `StepSchedule`,
the state's scheduler, holds the run's step counter (an int64 on the
device, the steps taken before this one, optax's count) and one float32
table of every schedule over the run's steps, filled once on the host by
the functions of utils/schedules.py, so the lr of step s is exactly
`lr_fn(s)`. Before each `optimizer.step()` a pre-hook reads the step's row
at the counter into the param groups (`lr`, a scheduled `weight_decay`,
Adam's bias corrections), and `StepSchedule.step()` advances the counter:
a step reads nothing on the host, so it replays as a CUDA graph
(train/trainer.py).

DINO's extras come in optax's order in the same pre-hook: `grad_clip`
clamps each gradient element to +-clip before the optimizer adds any decay,
and `weight_decay_fn` gives the decay of each step (for `sgd` the hook adds
it to the gradients itself, since the fused SGD takes its decay as a host
number). Each param group carries the counter as `count`, as optax's chain
state carries its count. A parameter without a gradient is skipped, as
torch's optimizers skip it.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

f32 = np.float32


def _adam_corrections(b: float) -> Callable[[int], float]:
    """The bias correction 1 - b**t of the step after `count` steps (t =
    count + 1), in float32, as optax takes it."""
    return lambda count: float(f32(1) - f32(b) ** f32(count + 1))


class OptaxAdam(torch.optim.Optimizer):
    """optax's scale_by_adam (b1 0.9, b2 0.999, `eps`) with coupled decay
    (`adam`: wd p added to the gradient) or decoupled (`adamw`: wd p added
    to Adam's update), then scaled by -lr. torch.optim.Adam/AdamW compute the
    same sum but take the bias corrections 1 - b**t in float64, where optax
    takes them in float32 (0.999 rounds to 1 - 0.99998713e-3, so 1 - b2**t is
    1.3e-5 small relatively): over ten steps their parameters end 1.6e-6 to
    1.8e-6 from optax's, this class's within 1e-6.

    Its step reads `lr`, `weight_decay` (a number or a tensor) and
    `bias_correction` (1 - b1**t, 1 - b2**t) from each param group, where
    its `StepSchedule` puts them before the step; each parameter's `step` is
    the group's `count`."""

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
            corr_mu, corr_nu = group["bias_correction"]
            decay = torch.is_tensor(wd) or wd != 0
            grads = [p.grad for p in params]
            if decay and not group["decoupled"]:
                grads = torch._foreach_add(grads, torch._foreach_mul(params, wd))
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if "mu" not in st:
                    st["mu"], st["nu"] = torch.zeros_like(p), torch.zeros_like(p)
                st["step"] = group["count"]
            mus, nus = [st["mu"] for st in states], [st["nu"] for st in states]
            # mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, as optax rounds them
            new_mu = torch._foreach_add(torch._foreach_mul(grads, 0.1), torch._foreach_mul(mus, 0.9))
            sq = torch._foreach_mul(grads, grads)
            new_nu = torch._foreach_add(torch._foreach_mul(sq, 1 - 0.999),
                                        torch._foreach_mul(nus, 0.999))
            torch._foreach_copy_(mus, new_mu)
            torch._foreach_copy_(nus, new_nu)
            denom = torch._foreach_sqrt(torch._foreach_div(new_nu, corr_nu))
            torch._foreach_add_(denom, eps)
            updates = torch._foreach_div(torch._foreach_div(new_mu, corr_mu), denom)
            if decay and group["decoupled"]:
                torch._foreach_add_(updates, torch._foreach_mul(params, wd))
            torch._foreach_mul_(updates, -lr)
            torch._foreach_add_(params, updates)


class StepSchedule:
    """The run's step counter on the device and the schedules tabled over
    its steps (the learning rate, and any other per-step number the
    optimizer or the algorithm reads: `at(name)`).

    `taken` is the host's count of the same steps, which checkpoints save
    (as `last_epoch`, LambdaLR's key, so a checkpoint of either loads into
    the other's place); a step past the table's end (more steps than the
    run was sized for: a profile after training) refills it twice as long
    (`reserve`)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 fns: dict[str, Callable[[int], float]], steps: int | None = None,
                 grad_clip: float | None = None):
        params = [p for g in optimizer.param_groups for p in g["params"]]
        self.fns = dict(fns)
        self.columns = {name: i for i, name in enumerate(self.fns)}
        self.grad_clip = grad_clip
        self.counter = torch.zeros((), dtype=torch.int64, device=params[0].device)
        self.taken = 0
        self._fill(max(int(steps or 1024), 1))
        # the group settings a loaded state dict must not undo (an SGD
        # checkpoint of torch's foreach form, a scheduled decay's 0)
        self._settings = [{k: g[k] for k in ("fused", "weight_decay") if k in g}
                          for g in optimizer.param_groups]
        optimizer.register_step_pre_hook(self._pre_step)
        optimizer.register_load_state_dict_post_hook(self._after_load)

    def _fill(self, n: int) -> None:
        rows = [[fn(s) for fn in self.fns.values()] for s in range(n)]
        self.table = torch.from_numpy(np.asarray(rows, dtype=f32).reshape(n, -1)).to(
            self.counter.device)

    def reserve(self, step: int) -> bool:
        """Makes the table hold the row of `step`, refilling it twice as long
        where it does not; True where it was refilled (a captured step reads
        the table it was captured with, so the caller captures anew)."""
        if step < self.table.shape[0]:
            return False
        self._fill(max(2 * self.table.shape[0], step + 1))
        return True

    def row(self) -> torch.Tensor:
        """Every schedule at the counter's step, (columns,) float32 on the
        device: one index read, no host read."""
        self.reserve(self.taken)
        return torch.index_select(self.table, 0, self.counter.reshape(1))[0]

    def at(self, name: str) -> torch.Tensor:
        """`name`'s value at the counter's step, a 0-dim float32 tensor."""
        return self.row()[self.columns[name]]

    def _pre_step(self, optimizer, args, kwargs):
        row = self.row()
        lr = row[self.columns["lr"]]
        wd = row[self.columns["weight_decay"]] if "weight_decay" in self.columns else None
        for group in optimizer.param_groups:
            group["lr"], group["count"] = lr, self.counter
            grads = [p.grad for p in group["params"] if p.grad is not None]
            if self.grad_clip is not None:
                torch._foreach_clamp_min_(grads, -self.grad_clip)
                torch._foreach_clamp_max_(grads, self.grad_clip)
            if "adam_c1" in self.columns:
                group["bias_correction"] = (row[self.columns["adam_c1"]],
                                            row[self.columns["adam_c2"]])
            if wd is None:
                continue
            if isinstance(optimizer, OptaxAdam):
                group["weight_decay"] = wd
            else:
                params = [p for p in group["params"] if p.grad is not None]
                torch._foreach_add_(grads, torch._foreach_mul(params, wd))

    def _after_load(self, optimizer):
        for group, settings in zip(optimizer.param_groups, self._settings):
            group.update(settings)

    def step(self) -> None:
        self.counter.add_(1)
        self.taken += 1

    def state_dict(self) -> dict:
        return {"last_epoch": self.taken}

    def load_state_dict(self, state: dict) -> None:
        self.taken = int(state["last_epoch"])
        self.counter.fill_(self.taken)


def get_optimizer(cfg: dict, params: Iterable[torch.nn.Parameter],
                  lr_fn: Callable[[int], float],
                  weight_decay_fn: Optional[Callable[[int], float]] = None,
                  grad_clip: Optional[float] = None, steps: int | None = None,
                  tables: dict[str, Callable[[int], float]] | None = None):
    """Returns (optimizer, its StepSchedule). `steps` sizes the tables (the
    run's steps and one); `tables` adds the algorithm's own schedules."""
    name = cfg.get("name", "sgd")
    wd = float(cfg.get("weight_decay", 1e-6))
    params = list(params)
    fns = {"lr": lr_fn, **(tables or {})}
    if weight_decay_fn is not None:
        fns["weight_decay"] = weight_decay_fn
    if name == "sgd":
        # lr: a tensor (the fused SGD reads it on the device), set each step
        opt = torch.optim.SGD(params, lr=torch.zeros((), device=params[0].device),
                              momentum=0.9, nesterov=True,
                              weight_decay=0.0 if weight_decay_fn is not None else wd,
                              fused=True)
    elif name in ("adam", "adamw"):
        opt = OptaxAdam(params, eps=float(cfg.get("epsilon", 1e-8)), weight_decay=wd,
                        decoupled=name == "adamw")
        fns.update(adam_c1=_adam_corrections(0.9), adam_c2=_adam_corrections(0.999))
    else:
        raise ValueError(f"Unknown optimizer {name!r}")
    return opt, StepSchedule(opt, fns, steps, None if grad_clip is None else float(grad_clip))
