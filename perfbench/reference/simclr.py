"""SimCLR (arXiv:2002.05709) as the shipped recipe trains it: one tower,
the ResNet-18 and the projection fc-bn-relu-fc-bn, run on each view
separately (each view's BN takes its own batch's statistics), and NT-Xent
over the 2N x 2N cosine similarity at the config's temperature; every
parameter trains. Two views and Nesterov SGD: the step loop's defaults."""

from __future__ import annotations

import torch

from . import resnet18
from .common import l2_normalize, mlp, mlp_specs

HEAD_BN = (0, 1)


def specs(cfg: dict) -> list:
    proj = int(cfg["proj_dim"])
    return (resnet18.specs("model.encoder.", cfg)
            + mlp_specs("model.proj.", [resnet18.FEATURES, resnet18.FEATURES, proj], HEAD_BN))


def trainable(names) -> list[str]:
    return [n for n in names if n.startswith("model.")]


def tower(params, x, cast):
    h = resnet18.forward(params, "model.encoder.", x, cast)
    return mlp(params, "model.proj.", h, 2, HEAD_BN, cast)


def nt_xent(z1, z2, temperature: float):
    """Float32 throughout: the recipe computes its loss outside autocast."""
    n = z1.shape[0]
    z = torch.cat([l2_normalize(z1), l2_normalize(z2)])
    sim = (z @ z.T) / temperature
    sim = sim.masked_fill(torch.eye(2 * n, dtype=torch.bool, device=z.device), -1e9)
    ar = torch.arange(n, device=z.device)
    pos = sim[torch.arange(2 * n, device=z.device), torch.cat([ar + n, ar])]
    return (torch.logsumexp(sim, dim=1) - pos).mean()


def loss(params: dict, views: list, cfg: dict, cast, state: dict):
    v1, v2 = views
    t = float(cfg["loss_fn"]["temperature"])
    return nt_xent(tower(params, v1, cast), tower(params, v2, cast), t)
