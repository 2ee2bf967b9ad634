"""The plain reference: the timed step's mathematics in plain PyTorch,
float32 with TF32 off, written from the papers and the shipped recipe. It
imports nothing of the program under test, of JAX or of the JAX package.

`run_steps` trains the configuration's algorithm (`reference/<algo>.py`,
found by the config's `algo`) for the first steps of a run from the
weights and images the benchmark hands to both sides. Every draw comes
from one generator of the run's seed of device draws, in the order the
shipped recipe takes them: the epoch's order of the images first (a
permutation of the train split, cut to whole batches), then each step's
views.

An algorithm's module gives `specs(cfg)` (the weights, `inputs.weights`),
`trainable(names)` and `loss(params, views, cfg, cast, state)`, and may
give these hooks, each with a default:

  * `views(generator, raw_u8, cfg) -> [view, ...]`, each view's first
    dimension the batch. Default: two views of the config's
    `data.transforms.train` (`augment.train_view`);
  * `init_state(weights, cfg) -> dict`: tensors that are neither trained
    nor compared (DINO's center), which `loss` and `after_update` get.
    Default: `{}`. The weights that `specs` marks as buffers are in
    `weights`, and not among the parameters;
  * `update(params, grads, opt_state, step, cfg, steps_per_epoch) ->
    grads`: the optimizer's step on `params` in place, keeping its own
    state in `opt_state`; returns the gradient it took, after any clamp
    of the recipe, which `run_steps` records as the first gradient.
    Default: `common.sgd_nesterov` at `common.lr_at`, the gradients
    returned unchanged;
  * `after_update(params, step, cfg, steps_per_epoch, state)`: what moves
    after the optimizer (an EMA tower, a center). Default: nothing.

`cast="fp8"` rounds to fp8 every tensor the recipe's bf16 autocast keeps
in bf16 (the control: `loss` gets the rounding as `cast` and applies it
where the recipe computes in bf16; the losses stay float32, as the recipe
computes them);
`fault` plants one of the faults the comparison must catch: `frozen` (the
state left unchanged: no `update`, no `after_update`), `frozen_late` (the
same from the fourth step on, where a program that captures its step
after three warm-up steps replays it), `half` (every view cut to half its
batch, the mean taken over the rest), `grad2` (the first trained leaf's
gradient doubled before `update` gets it). Where a fault skips `update`,
the first gradient recorded is the one `update` would have been given.
"""

from __future__ import annotations

import importlib

import torch

from ..inputs import buffers
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


def views(generator, raw_u8, cfg: dict) -> list:
    view_cfg = cfg["data"]["transforms"]["train"]
    return [train_view(generator, raw_u8, view_cfg), train_view(generator, raw_u8, view_cfg)]


def init_state(weights: dict, cfg: dict) -> dict:
    return {}


def update(params: dict, grads: dict, opt_state: dict, step: int, cfg: dict,
           steps_per_epoch: int) -> dict:
    sgd_nesterov(params, grads, opt_state, lr_at(step, cfg, steps_per_epoch), cfg)
    return grads


def after_update(params: dict, step: int, cfg: dict, steps_per_epoch: int, state: dict) -> None:
    """Nothing beyond the optimizer's update."""


DEFAULTS = {"views": views, "init_state": init_state, "update": update,
            "after_update": after_update}


def run_steps(cfg: dict, weights: dict, images_u8, steps: int, seed: int,
              steps_per_epoch: int, cast: str = "float32", fault: str | None = None) -> dict:
    """The first `steps` steps of the first epoch: {"losses": [one a
    step], "first_grad": {name: the first step's gradient as the optimizer
    took it}, "params": {name: after the last step}}; the weights marked as
    buffers are not among the params."""
    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    algo = algorithm(cfg["algo"])
    hook = {name: getattr(algo, name, default) for name, default in DEFAULTS.items()}
    rnd = CASTS[cast]
    generator = torch.Generator(device=images_u8.device).manual_seed(seed)
    rows = epoch_rows(generator, images_u8.shape[0], int(cfg["data"]["batch_size"]))[:steps]
    marked = buffers(algo.specs(cfg))
    params = {k: v.detach().clone() for k, v in weights.items() if k not in marked}
    state = hook["init_state"](weights, cfg)
    train = algo.trainable(params)
    opt_state, losses, first = {}, [], None
    for k, idx in enumerate(rows):
        got = hook["views"](generator, images_u8[idx], cfg)
        if fault == "half":
            got = [v[: v.shape[0] // 2] for v in got]
        leaves = [params[n].requires_grad_(True) for n in train]
        loss = algo.loss(params, got, cfg, rnd, state)
        grads = dict(zip(train, torch.autograd.grad(loss, leaves)))
        for p in leaves:
            p.requires_grad_(False)
        if fault == "grad2":
            grads[train[0]] = 2.0 * grads[train[0]]
        if fault != "frozen" and not (fault == "frozen_late" and k >= 3):
            grads = hook["update"](params, grads, opt_state, k, cfg, steps_per_epoch)
            hook["after_update"](params, k, cfg, steps_per_epoch, state)
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first, "params": params}
