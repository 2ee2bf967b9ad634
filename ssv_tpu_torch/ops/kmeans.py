"""K-means (Lloyd) with restarts on the device (port of ssv_tpu/ops/kmeans.py).

DeepCluster's clustering of the train split's features. The `n_redo`
restarts run together, as the JAX package's `vmap` runs them: each
iteration is one (N, d) x (d, R*K) product that scores every point against
the centroids of all R restarts, and one (R*K, N) x (N, d) product of the
one-hot assignments that sums each cluster's rows. No Python loop over the
restarts, and no read to the host, inside the iterations. Float32 throughout
(TF32 is off in the port). The restarts' initial rows come from a
`torch.Generator`; torch cannot reproduce `jax.random.choice`, so the rows
drawn differ from the JAX package's for the same seed.
"""

from __future__ import annotations

import torch


def _assign(x, centroids):
    """argmin_k ||x - c_k||^2 by the expanded form c^2 - 2 x.c (x.x is the
    same for every k), the first index on a tie; returns (assignments,
    squared distances). `centroids` is (K, d) or (R, K, d); the results are
    (N,) or (N, R)."""
    d = centroids.shape[-1]
    dots = (x @ centroids.reshape(-1, d).T).reshape(x.shape[0], *centroids.shape[:-1])
    dist = centroids.square().sum(dim=-1) - 2.0 * dots
    min_dist, assign = dist.min(dim=-1)
    x2 = x.square().sum(dim=1)
    return assign, min_dist + x2.reshape(-1, *[1] * (min_dist.ndim - 1))


def _lloyd(x, init_centroids, n_iters: int):
    """`n_iters` Lloyd steps from (R, K, d) centroids; an empty cluster keeps
    its centroid (faiss re-seeds it). Returns (centroids (R, K, d),
    assignments (N, R), inertia (R,))."""
    r, k, d = init_centroids.shape
    centroids = init_centroids
    ks = torch.arange(k, device=x.device)
    for _ in range(n_iters):
        assign, _ = _assign(x, centroids)                                # (N, R)
        one_hot = (assign[..., None] == ks).to(x.dtype).reshape(-1, r * k)
        counts = one_hot.sum(dim=0)                                      # (R*K,)
        sums = one_hot.T @ x                                             # (R*K, d)
        new = (sums / counts.clamp(min=1.0)[:, None]).reshape(r, k, d)
        centroids = torch.where((counts > 0).reshape(r, k, 1), new, centroids)
    assign, dist = _assign(x, centroids)
    return centroids, assign, dist.sum(dim=0)


def _init_rows(generator: torch.Generator, n: int, k: int, n_redo: int) -> torch.Tensor:
    """(n_redo, k) row indices: k distinct rows for each restart."""
    return torch.stack([torch.randperm(n, generator=generator, device=generator.device)[:k]
                        for _ in range(n_redo)])


def kmeans(generator: torch.Generator, x, k: int, n_iters: int = 300, n_redo: int = 10):
    """Returns (centroids (k, d), assignments (N,), inertia) of the best of
    `n_redo` restarts, each from k distinct random rows of `x` (faiss's
    default init); the least inertia wins, the first restart on a tie."""
    x = x.float()
    rows = _init_rows(generator, x.shape[0], k, n_redo).to(x.device)
    centroids, assign, inertia = _lloyd(x, x[rows], n_iters)
    best = inertia.argmin()
    return centroids[best], assign[:, best], inertia[best]
