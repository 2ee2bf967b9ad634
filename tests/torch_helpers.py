"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Each test makes its inputs with numpy from a seed, runs the JAX function and
the port's counterpart on them, and compares the results as numpy arrays.
"""

import os
import pickle

import jax
import numpy as np
import torch


def to_numpy_tree(tree):
    """A flax variable tree (nested dicts of JAX arrays) as numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def stage_fake_cifar(root, n_train=128, n_test=256, seed=0):
    """Tiny CIFAR-10 pickle batches (data_batch_1..5, n_train images in all,
    + test_batch) under root/cifar-10-batches-py, so a loader takes the real
    reader path."""
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i, n in enumerate(np.array_split(np.arange(n_train), 5), start=1):
        with open(os.path.join(d, f"data_batch_{i}"), "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (len(n), 3072), dtype=np.uint8),
                         "labels": rng.randint(0, 10, len(n)).tolist()}, f)
    with open(os.path.join(d, "test_batch"), "wb") as f:
        pickle.dump({"data": rng.randint(0, 256, (n_test, 3072), dtype=np.uint8),
                     "labels": rng.randint(0, 10, n_test).tolist()}, f)
    return d


def t(a, dtype=None):
    """numpy -> CPU torch tensor (a copy, so the numpy input stays intact)."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)
