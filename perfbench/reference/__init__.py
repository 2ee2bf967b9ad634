"""The plain reference: the timed step's mathematics in plain PyTorch,
float32 with TF32 off, written from the papers and the shipped recipe. It
imports nothing of the program under test, of JAX or of the JAX package.

`run_steps` trains the configuration's algorithm (`reference/<algo>.py`,
found by the config's `algo`) for the first steps of a run from the
weights and images the benchmark hands to both sides. Every draw comes
from one generator of the run's seed of device draws, in the order the
shipped recipe takes them: the epoch's order of the images first (a
permutation of the train split, cut to whole batches), then each view's
augmentation, step after step.
`cast="fp8"` rounds to fp8 every tensor the recipe's bf16 autocast keeps
in bf16 (the control: each convolution's and linear layer's operands and
result, each BN output and residual sum of the backbone; the losses stay
float32, as the recipe computes them);
`fault` plants one of the faults the comparison must catch: `frozen` (the
state left unchanged), `frozen_late` (the state left unchanged from the
fourth step on, where a program that captures its step after three warm-up
steps replays it), `half` (half of the batch left out, the mean taken over
the rest), `grad2` (the first leaf's gradient doubled).
"""

from __future__ import annotations

import importlib

import torch

from .augment import train_view
from .common import CASTS, lr_at, sgd_nesterov

FAULTS = (None, "frozen", "frozen_late", "half", "grad2")


def algorithm(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def epoch_rows(generator, n_train: int, batch: int):
    """The epoch's (steps, batch) index matrix: a permutation of the train
    split, cut to whole batches."""
    perm = torch.randperm(n_train, generator=generator, device=generator.device)
    steps = n_train // batch
    return perm[: steps * batch].reshape(steps, batch)


def run_steps(cfg: dict, weights: dict, images_u8, steps: int, seed: int,
              steps_per_epoch: int, cast: str = "float32", fault: str | None = None) -> dict:
    """The first `steps` steps of the first epoch: {"losses": [one a
    step], "first_grad": {name: the first step's gradient}, "params":
    {name: after the last step}}."""
    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    algo = algorithm(cfg["algo"])
    rnd = CASTS[cast]
    generator = torch.Generator(device=images_u8.device).manual_seed(seed)
    rows = epoch_rows(generator, images_u8.shape[0], int(cfg["data"]["batch_size"]))[:steps]
    params = {k: v.detach().clone() for k, v in weights.items()}
    train = algo.trainable(params)
    view_cfg = cfg["data"]["transforms"]["train"]
    bufs, losses, first = {}, [], None
    for k, idx in enumerate(rows):
        raw = images_u8[idx]
        v1, v2 = train_view(generator, raw, view_cfg), train_view(generator, raw, view_cfg)
        if fault == "half":
            v1, v2 = v1[: v1.shape[0] // 2], v2[: v2.shape[0] // 2]
        leaves = [params[n].requires_grad_(True) for n in train]
        loss = algo.loss(params, v1, v2, cfg, rnd)
        grads = dict(zip(train, torch.autograd.grad(loss, leaves)))
        for p in leaves:
            p.requires_grad_(False)
        if fault == "grad2":
            grads[train[0]] = 2.0 * grads[train[0]]
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        if fault != "frozen" and not (fault == "frozen_late" and k >= 3):
            sgd_nesterov(params, grads, bufs, lr_at(k, cfg, steps_per_epoch), cfg)
            algo.after_update(params, k, cfg, steps_per_epoch)
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first, "params": params}
