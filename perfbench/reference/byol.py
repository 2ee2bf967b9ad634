"""BYOL (arXiv:2006.07733) as the shipped recipe trains it: an online
tower (ResNet-18, projector fc-bn-relu-fc, predictor fc-bn-relu-fc, the
output L2-normalised) against a target tower (ResNet-18 and projector,
L2-normalised) drawn on its own; the target runs each view in training
mode without gradients; the loss is the mean squared error between each
online output and the other view's target output, summed over the two
views; after SGD updates the online tower, the target's encoder and
projector move to tau target + (1 - tau) online, tau on a cosine from the
config's `tau` to 1 over the run's steps, taken at the step before the
update."""

from __future__ import annotations

import torch

from . import resnet18
from .common import cosine_ramp, l2_normalize, mlp, mlp_specs

BN = (0,)


def specs(cfg: dict) -> list:
    d, p = resnet18.FEATURES, int(cfg["proj_dim"])
    out = []
    for side in ("model", "target"):
        out += resnet18.specs(f"{side}.encoder.", cfg)
        out += mlp_specs(f"{side}.proj.", [d, d, p], BN)
        if side == "model":
            out += mlp_specs("model.pred.", [p, p, p], BN)
    return out


def trainable(names) -> list[str]:
    return [n for n in names if n.startswith("model.")]


def tower(params, side: str, x, cast):
    z = mlp(params, f"{side}.proj.", resnet18.forward(params, f"{side}.encoder.", x, cast),
            2, BN, cast)
    if side == "model":
        z = mlp(params, "model.pred.", z, 2, BN, cast)
    return l2_normalize(z)


def loss(params: dict, views: list, cfg: dict, cast, state: dict):
    v1, v2 = views
    with torch.no_grad():
        t1, t2 = tower(params, "target", v1, cast), tower(params, "target", v2, cast)
    o1, o2 = tower(params, "model", v1, cast), tower(params, "model", v2, cast)
    return ((o1 - t2) ** 2).mean() + ((o2 - t1) ** 2).mean()


@torch.no_grad()
def after_update(params: dict, step: int, cfg: dict, steps_per_epoch: int, state: dict) -> None:
    tau = cosine_ramp(step, int(cfg["epochs"]) * steps_per_epoch,
                      float(cfg.get("tau", 0.996)), 1.0)
    for name in params:
        if name.startswith(("target.encoder.", "target.proj.")):
            online = params["model." + name[len("target."):]]
            params[name].copy_(tau * params[name] + (1.0 - tau) * online)
