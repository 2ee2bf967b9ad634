"""SSL objectives (port of ssv_tpu/objectives/losses.py, the slice's part).

Losses take and compute in float32; call them outside any autocast region.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def l2_normalize(x, dim=-1, eps=1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def softmax_cross_entropy(logits, labels):
    """Mean CE with integer labels (torch F.cross_entropy semantics)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[:, None].long())[:, 0].mean()


def nt_xent(zi, zj, temperature: float = 1.0, normalize: bool = False):
    """NT-Xent (reference losses.py:8-46) as a masked logsumexp over the
    2N x 2N similarity: anchor a's positive is the other view of the same
    example, its negatives the other 2N-2 views. The diagonal is masked
    with NEG_INF (-1e9), not -inf, as in the JAX version."""
    if normalize:
        zi, zj = l2_normalize(zi), l2_normalize(zj)
    n = zi.shape[0]
    z = torch.cat([zi, zj], dim=0)
    sim = (z @ z.T) / temperature
    diag = torch.eye(2 * n, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(diag, NEG_INF)
    ar = torch.arange(n, device=z.device)
    pos_idx = torch.cat([ar + n, ar])
    pos = torch.gather(sim, 1, pos_idx[:, None])[:, 0]
    return (torch.logsumexp(sim, dim=1) - pos).mean()
