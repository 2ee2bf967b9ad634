"""SSL objectives (port of ssv_tpu/objectives/losses.py: NT-Xent, MoCo's
InfoNCE, BYOL, SimSiam, Barlow Twins, ReLIC, SwAV's Sinkhorn codes and
swapped prediction, SeLA's self-labelling, DINO's centred cross-entropy and
PIRL's two-term NCE).

Losses take and compute in float32; call them outside any autocast region.

SwAV's two functions also run column-parallel over a model group (`group`):
each rank holds K/M prototypes' columns of the scores, and the reductions
over K cross the group (`parallel/per_device.py`).
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import group_size
from ..parallel.per_device import copy_to_group, group_logsumexp, group_sum

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


def moco_nce(query, keys, queue, temperature: float = 1.0, normalize: bool = True):
    """InfoNCE against a queue: the positive of each query is its own key,
    the negatives the queue rows; CE with label 0. The queue rows are used
    as stored, not re-normalized (the reference's quirk: they are normalized
    when pushed)."""
    if normalize:
        query, keys = l2_normalize(query), l2_normalize(keys)
    pos = (query * keys).sum(dim=-1, keepdim=True) / temperature
    neg = (query @ queue.T) / temperature
    logits = torch.cat([pos, neg], dim=1)
    labels = torch.zeros(query.shape[0], dtype=torch.int64, device=query.device)
    return softmax_cross_entropy(logits, labels)


def byol_mse(online_1, online_2, target_1, target_2):
    """MSE over all elements (a 1/(N*D) scale, not 2 - 2cos) between each
    online output and the other view's target, summed over the two views;
    the inputs come L2-normalized from the towers."""
    l1 = ((online_1 - target_2.detach()) ** 2).mean()
    l2 = ((online_2 - target_1.detach()) ** 2).mean()
    return l1 + l2


def simsiam_neg_cosine(online, target):
    """-(o . t).sum(1).mean() with both inputs pre-normalized; `detach` is
    the paper's stop-grad on the target."""
    return -(online * target.detach()).sum(dim=1).mean()


def barlow_twins(zi, zj, off_diagonal_weight: float = 0.005, normalize: bool = True):
    """Standardize each dim over the batch (unbiased std, ddof=1, as torch's
    `.std` in the reference), cross-correlate, and sum (C - I)^2 with the
    off-diagonal terms weighted by `off_diagonal_weight`."""
    if normalize:
        zi, zj = l2_normalize(zi), l2_normalize(zj)
    bs, d = zi.shape
    zi = (zi - zi.mean(dim=0)) / zi.std(dim=0, correction=1)
    zj = (zj - zj.mean(dim=0)) / zj.std(dim=0, correction=1)
    corr = (zi.T @ zj) / bs
    eye = torch.eye(d, dtype=corr.dtype, device=corr.device)
    weight = torch.full_like(corr, off_diagonal_weight).fill_diagonal_(1.0)
    return (((corr - eye) ** 2) * weight).sum()


def relic_loss(zi, zj, z_orig, temperature: float = 1.0, alpha: float = 0.5,
               normalize: bool = True, corrected: bool = False):
    """NT-Xent between the views plus alpha times a KL invariance term over
    the batch softmax of each view's similarity to the original image. By
    default the reference's quirk is kept: probabilities, not log-probs,
    are the KL input, so kl = sum(p_j * (log p_j - p_i)); `corrected=True`
    gives KL(p_j || p_i) = sum(p_j * (log p_j - log p_i))."""
    if normalize:
        zi, zj, z_orig = l2_normalize(zi), l2_normalize(zj), l2_normalize(z_orig)
    contrastive = nt_xent(zi, zj, temperature=temperature, normalize=False)
    sim_io = (zi * z_orig).sum(dim=-1) / temperature
    sim_jo = (zj * z_orig).sum(dim=-1) / temperature
    log_pj = torch.log_softmax(sim_jo, dim=-1)
    if corrected:
        kl = (log_pj.exp() * (log_pj - torch.log_softmax(sim_io, dim=-1))).sum()
    else:
        kl = (log_pj.exp() * (log_pj - torch.softmax(sim_io, dim=-1))).sum()
    return contrastive + alpha * kl


@torch.no_grad()
def sinkhorn_codes(scores, eps: float = 0.05, n_iters: int = 3, group=None):
    """Sinkhorn-Knopp codes: exp(s / eps)^T scaled in turn to uniform row
    (over the K prototypes) and column (over the B samples) marginals,
    `n_iters` times, then column-normalized and transposed back to (B, K).
    Each step runs in the log domain (logsumexp), so s / eps > 88, where
    exp overflows float32, stays finite. No gradient flows through.

    With a `group`, `scores` are this rank's (B, K/M) columns and so are the
    codes: the row step (over samples) stays local, the column steps (over
    prototypes) take a logsumexp across the group, and the row marginal is
    the global K's."""
    lq = (scores / eps).T                       # (K, B) log kernel
    k, b = lq.shape
    if group is None:
        def over_k(x):
            return torch.logsumexp(x, dim=0, keepdim=True)
    else:
        k *= group_size(group)

        def over_k(x):
            return group_logsumexp(x, 0, group, keepdim=True)
    lr, lc = -math.log(k), -math.log(b)         # log uniform marginals
    for _ in range(n_iters):
        lq = lq - torch.logsumexp(lq, dim=1, keepdim=True) + lr
        lq = lq - over_k(lq) + lc
    return torch.exp(lq - over_k(lq)).T


def swav_loss(z1, z2, prototypes, bank_features=None, temperature: float = 0.1,
              sinkhorn_eps: float = 0.05, sinkhorn_iters: int = 3, group=None):
    """Swapped prediction: the codes of view 1 supervise view 2 and the
    codes of view 2 view 1. The bank's rows, detached, are concatenated to
    both views to fatten the assignment problem. Scores in float32.

    With a `group`, `prototypes` are this rank's K/M rows of the table and z1,
    z2 the same on every rank of the group: the scores are a local (B', K/M)
    product, the log-softmax over K takes its logsumexp across the group,
    and each sample's sum over K is a per-shard partial summed across it."""
    if group is not None:
        z1, z2 = copy_to_group(z1, group), copy_to_group(z2, group)
    if bank_features is not None:
        bank_features = bank_features.detach()
        z1 = torch.cat([z1, bank_features])
        z2 = torch.cat([z2, bank_features])
    s1, s2 = z1 @ prototypes.T, z2 @ prototypes.T
    q1 = sinkhorn_codes(s1, sinkhorn_eps, sinkhorn_iters, group)
    q2 = sinkhorn_codes(s2, sinkhorn_eps, sinkhorn_iters, group)
    if group is None:
        p1 = torch.log_softmax(s1 / temperature, dim=-1)
        p2 = torch.log_softmax(s2 / temperature, dim=-1)
        return -0.5 * ((q1 * p2).sum(dim=1) + (q2 * p1).sum(dim=1)).mean()
    s1, s2 = s1 / temperature, s2 / temperature
    p1 = s1 - group_logsumexp(s1, -1, group, keepdim=True)
    p2 = s2 - group_logsumexp(s2, -1, group, keepdim=True)
    return -0.5 * group_sum((q1 * p2).sum(dim=1) + (q2 * p1).sum(dim=1), group).mean()


@torch.no_grad()
def sela_self_label(logits, alpha, beta, lmbda: float = 25.0, n_iters: int = 80):
    """The reference's batch-wise self-labelling: P = log_softmax(logits) **
    lmbda as (K, B); alpha = 1 / (P beta) and beta = 1 / (alpha^T P) in turn
    for `n_iters`; the labels are the argmax over K of diag(alpha) P
    diag(beta). Returns (labels, alpha, beta): alpha (K, 1) and beta (B, 1)
    carry over to the next batch. For an odd lmbda P is negative, as
    `torch.pow` and `jnp` both define it; past |log p| of about 34.8, P
    overflows float32 at lmbda 25 on both sides."""
    p = (torch.log_softmax(logits, dim=-1) ** lmbda).T      # (K, B)
    for _ in range(n_iters):
        alpha = 1.0 / (p @ beta)
        beta = 1.0 / (alpha.T @ p).T
    scaled = (alpha * p * beta.T).T                          # (B, K)
    return scaled.argmax(dim=-1), alpha, beta


def dino_loss(teacher_views, student_views, temp_s: float, temp_t: float, center):
    """DINO's loss (reference losses.py:75-89). `teacher_views` (B, Vg, K)
    are the teacher's global-view outputs, `student_views` (B, Vg + Vl, K)
    all the student's. Over each teacher view t, the cross-entropy of
    softmax((t - center) / temp_t) against log_softmax(student / temp_s),
    averaged over the batch and over *all* student views, including the
    student's view of the same crop, as the reference does; the teacher
    side carries no gradient."""
    teacher_views = teacher_views.detach()
    logp_s = torch.log_softmax(student_views / temp_s, dim=-1)       # (B, V, K)
    total = 0.0
    for t in range(teacher_views.shape[1]):
        probs_t = torch.softmax((teacher_views[:, t, :] - center) / temp_t, dim=-1)
        total = total - (probs_t[:, None, :] * logp_s).sum(dim=-1).mean()
    return total


NEGATIVES_FROM = ("features", "memory")


def pirl_nce(img_features, patch_features, memory_pos, memory_neg,
             temperature: float = 1.0, loss_weight: float = 0.5,
             normalize: bool = True, negatives_from: str = "memory"):
    """PIRL's NCE against a per-sample bank (reference losses.py:92-117):
    loss_weight * CE(patch) + (1 - loss_weight) * CE(image), each with its
    bank row `memory_pos` as the positive (label 0) and the sampled bank rows
    `memory_neg` as negatives. `negatives_from="features"` scores each term's
    own features against the negatives; `"memory"` keeps the reference's
    quirk, one negative block mm(memory_pos, memory_neg^T) shared by both
    terms, so no repulsion gradient reaches the features."""
    if negatives_from not in NEGATIVES_FROM:
        raise ValueError(f"negatives_from must be one of {NEGATIVES_FROM}, "
                         f"got {negatives_from!r}")
    if normalize:
        img_features, patch_features = l2_normalize(img_features), l2_normalize(patch_features)
    pos1 = (memory_pos * patch_features).sum(dim=-1, keepdim=True) / temperature
    pos2 = (memory_pos * img_features).sum(dim=-1, keepdim=True) / temperature
    if negatives_from == "features":
        neg1 = (patch_features @ memory_neg.T) / temperature
        neg2 = (img_features @ memory_neg.T) / temperature
    else:
        neg1 = neg2 = (memory_pos @ memory_neg.T) / temperature
    labels = torch.zeros(img_features.shape[0], dtype=torch.int64, device=img_features.device)
    loss1 = softmax_cross_entropy(torch.cat([pos1, neg1], dim=1), labels)
    loss2 = softmax_cross_entropy(torch.cat([pos2, neg2], dim=1), labels)
    return loss_weight * loss1 + (1.0 - loss_weight) * loss2
