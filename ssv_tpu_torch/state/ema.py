"""EMA (momentum) updates over parameters (port of ssv_tpu/state/ema.py)."""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch


@torch.no_grad()
def ema_update(target_params: Iterable[torch.Tensor],
               online_params: Iterable[torch.Tensor], tau) -> None:
    """target <- tau * target + (1 - tau) * online, in place, as the JAX
    formula rounds it: two products, then their sum (`lerp` rounds
    otherwise). `tau` is a float or a 0-dim float32 tensor on the device (a
    step's scheduled value, read without the host); `1 - tau` is taken in
    float32, as JAX takes it. BN running statistics are buffers, not
    parameters, and are not averaged."""
    target, online = list(target_params), list(online_params)
    if len(target) != len(online):
        raise ValueError(f"{len(target)} target tensors for {len(online)} online ones")
    rest = 1 - tau if torch.is_tensor(tau) else float(np.float32(1) - np.float32(tau))
    torch._foreach_mul_(target, tau)
    torch._foreach_add_(target, torch._foreach_mul(online, rest))
