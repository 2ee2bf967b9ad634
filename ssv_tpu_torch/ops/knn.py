"""On-device exact KNN (port of ssv_tpu/ops/knn.py).

A chunked similarity matmul + `torch.topk`. Metric as the reference's
(eval_utils.py:13-21): mean over anchors of the fraction of the k nearest
neighbors (inner product on L2-normalized features, self excluded) sharing
the anchor's label. The self-hit is excluded by masking it to -inf.
"""

from __future__ import annotations

import torch

from ..objectives.losses import l2_normalize


def cosine_topk(queries, corpus, k: int, exclude_offset: int | None = None,
                chunk: int = 2048):
    """Top-k inner-product neighbors of each query row in `corpus`.

    If `exclude_offset` is not None, query i is corpus row
    (i + exclude_offset) and that entry is masked. Returns (scores, indices)
    of shape (Nq, k), chunked over queries to bound the similarity tile."""
    scores, indices = [], []
    for start in range(0, queries.shape[0], chunk):
        q = queries[start:start + chunk]
        sims = q @ corpus.T
        if exclude_offset is not None:
            rows = torch.arange(q.shape[0], device=q.device)
            sims[rows, rows + start + exclude_offset] = float("-inf")
        s, idx = torch.topk(sims, k, dim=1)
        scores.append(s)
        indices.append(idx)
    return torch.cat(scores), torch.cat(indices)


def knn_label_agreement(features, labels, k: int = 20, chunk: int = 2048,
                        normalize: bool = True):
    """The reference's `compute_neighbor_accuracy`, as a device scalar."""
    f = l2_normalize(features) if normalize else features
    _, nbrs = cosine_topk(f, f, k, exclude_offset=0, chunk=chunk)
    return (labels[nbrs] == labels[:, None]).float().mean()
