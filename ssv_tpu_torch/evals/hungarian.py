"""Hungarian matching of cluster ids to class ids (a copy of
ssv_tpu/evals/hungarian.py, which the port cannot import: the JAX package's
`evals/__init__.py` imports JAX).

Same contract as the reference (eval_utils.py:23-35): build the vote matrix
between predicted cluster ids and targets, solve the assignment maximizing
agreement, return the cluster -> class map. The cost matrix is k x k (k=10
for DeepCluster) so this is host-side; scipy's LAPJV solver is used when
available with a pure-NumPy O(n^3) Hungarian fallback.
"""

from __future__ import annotations

import numpy as np

try:
    from scipy.optimize import linear_sum_assignment as _lsa
except ImportError:  # pragma: no cover
    _lsa = None


def _hungarian_numpy(cost: np.ndarray):
    """Classic O(n^3) Hungarian algorithm (potentials + augmenting paths)."""
    n = cost.shape[0]
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    p = np.zeros(n + 1, dtype=int)   # p[j] = row assigned to column j
    way = np.zeros(n + 1, dtype=int)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, np.inf)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0, delta, j1 = p[j0], np.inf, -1
            for j in range(1, n + 1):
                if not used[j]:
                    cur = cost[i0 - 1, j - 1] - u[i0] - v[j]
                    if cur < minv[j]:
                        minv[j] = cur
                        way[j] = j0
                    if minv[j] < delta:
                        delta = minv[j]
                        j1 = j
            for j in range(n + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            p[j0] = p[way[j0]]
            j0 = way[j0]
    rows = np.empty(n, dtype=int)
    cols = np.arange(n)
    for j in range(1, n + 1):
        rows[j - 1] = p[j] - 1
    order = np.argsort(rows)
    return rows[order], cols[order]


def hungarian_match(pred, targets, pred_k: int, targets_k: int) -> dict:
    pred = np.asarray(pred)
    targets = np.asarray(targets)
    votes = np.zeros((pred_k, targets_k))
    for c1 in range(pred_k):
        mask = pred == c1
        if mask.any():
            votes[c1] = np.bincount(targets[mask], minlength=targets_k)
    cost = pred.shape[0] - votes
    if _lsa is not None:
        rows, cols = _lsa(cost)
    else:
        rows, cols = _hungarian_numpy(cost)
    return {int(r): int(c) for r, c in zip(rows, cols)}
