"""KNN validation with the reference's name and signature
(`compute_neighbor_accuracy(fvecs, targets, k=20)`, eval_utils.py:13-21)."""

from __future__ import annotations

import torch

from ..ops.knn import knn_label_agreement


def compute_neighbor_accuracy(fvecs, targets, k: int = 20) -> float:
    return float(knn_label_agreement(torch.as_tensor(fvecs), torch.as_tensor(targets), k=k))
