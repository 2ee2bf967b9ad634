"""Learning-rate and ramp schedules as functions of the global step
(port of ssv_tpu/utils/schedules.py, the slice's part).

They are evaluated in float32, as the JAX package's are, so that a step's
learning rate is the same number in both; each returns a Python float.
"""

from __future__ import annotations

import numpy as np

f32 = np.float32


def cosine_ramp(step, total_steps, lower: float, upper: float):
    """upper - (upper-lower) * (cos(pi * step/total) + 1) / 2: ``lower`` at
    step 0, ``upper`` at step == total_steps."""
    frac = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0), f32(1))
    return float(f32(upper) - f32(upper - lower) * (np.cos(f32(np.pi) * frac) + f32(1))
                 / f32(2))


def warmup_cosine(step, *, base_lr: float, total_steps: int, warmup_steps: int,
                  end_lr: float = 0.0):
    """Per-step linear warmup from ~0 to base_lr, then cosine decay to end_lr."""
    step = f32(step)
    if step < warmup_steps:
        return float(f32(1e-12) + f32(base_lr - 1e-12) * step / f32(max(warmup_steps, 1)))
    decay_steps = f32(max(total_steps - warmup_steps, 1))
    frac = np.clip((step - f32(warmup_steps)) / decay_steps, f32(0), f32(1))
    cos = f32(end_lr) + f32((base_lr - end_lr) * 0.5) * (f32(1) + np.cos(f32(np.pi) * frac))
    return float(cos)


def multistep(step, *, base_lr: float, milestones_steps, gamma: float):
    """lr = base_lr * gamma ** (#milestones passed). Milestones in steps."""
    n_passed = sum(step >= m for m in milestones_steps)
    return float(f32(base_lr) * f32(gamma) ** f32(n_passed))


def lr_schedule(optimizer_cfg: dict, scheduler_cfg: dict, *, epochs: int,
                steps_per_epoch: int):
    """`lr(step)` from the reference YAML schema: `cosine` = linear warmup
    over `warmup_epochs` then cosine decay; `multistep` = staircase decay at
    `milestones` (epochs) by `gamma`; anything else = constant."""
    base_lr = float(optimizer_cfg["lr"])
    name = (scheduler_cfg or {}).get("name", "none")
    total_steps = epochs * steps_per_epoch

    if name == "cosine":
        warmup_steps = int(scheduler_cfg.get("warmup_epochs", 0)) * steps_per_epoch
        return lambda step: warmup_cosine(step, base_lr=base_lr, total_steps=total_steps,
                                          warmup_steps=warmup_steps)
    if name == "multistep":
        ms = [int(m) * steps_per_epoch for m in scheduler_cfg["milestones"]]
        gamma = float(scheduler_cfg.get("gamma", 0.1))
        return lambda step: multistep(step, base_lr=base_lr, milestones_steps=ms,
                                      gamma=gamma)
    return lambda step: float(f32(base_lr))
