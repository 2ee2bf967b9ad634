"""The port's linear probe against ssv_tpu.evals.linear.linear_evaluation:
the loop run from the JAX probe's own initial weights and index matrix, on
features whose accuracy is not saturated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssv_tpu.evals.linear import linear_evaluation as jax_linear_evaluation
from ssv_tpu_torch.evals.linear import linear_evaluation, train_probe
from torch_helpers import t

torch.set_num_threads(2)

CLASSES = 5


def _features(seed, n, d=24):
    """Class means shared by both splits, in noise of std 1: an accuracy
    neither at chance nor at 1.0."""
    means = np.random.RandomState(99).randn(CLASSES, d).astype(np.float32) * 0.4
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, CLASSES, n).astype(np.int32)
    return (means[labels] + rs.randn(n, d)).astype(np.float32), labels


def _jax_draws(n, d, epochs, batch, seed=0):
    """The JAX probe's initial weights and (steps, batch) index matrix, drawn
    as ssv_tpu/evals/linear.py draws them."""
    k_init, k_perm = jax.random.split(jax.random.PRNGKey(seed))
    w = jax.random.normal(k_init, (d, CLASSES)) * (1.0 / jnp.sqrt(d))
    steps = max(n // batch, 1)
    perms = jax.vmap(lambda k: jax.random.permutation(k, n)[: steps * batch])(
        jax.random.split(k_perm, epochs))
    return np.asarray(w), np.asarray(perms.reshape(epochs * steps, batch))


@pytest.mark.parametrize("cfg", [
    {"epochs": 5, "batch_size": 64, "lr": 0.1},
    {"epochs": 3, "batch_size": 1000, "lr": 0.5, "weight_decay": 1e-3, "momentum": 0.8},
])
def test_probe_matches_jax(cfg):
    """Same draws, same accuracy within one test sample."""
    x, y = _features(0, 600)
    xt, yt = _features(1, 400)
    want = jax_linear_evaluation(cfg, {"fvecs": x, "labels": y},
                                 {"fvecs": xt, "labels": yt}, CLASSES)
    assert 0.3 < want < 0.95
    batch = min(cfg["batch_size"], len(x))
    w, idx_mat = _jax_draws(len(x), x.shape[1], cfg["epochs"], batch)
    got = train_probe(cfg, t(x), t(y, torch.int64), t(xt), t(yt, torch.int64), t(w),
                      torch.zeros(CLASSES), t(idx_mat, torch.int64))
    assert abs(got - want) <= 1.0 / len(xt) + 1e-9, (got, want)


def test_probe_own_draws():
    """With its own draws the probe lands near the JAX accuracy, and is
    deterministic for a seed."""
    cfg = {"epochs": 5, "batch_size": 64, "lr": 0.1}
    x, y = _features(0, 600)
    xt, yt = _features(1, 400)
    train, test = {"fvecs": x, "labels": y}, {"fvecs": xt, "labels": yt}
    want = jax_linear_evaluation(cfg, train, test, CLASSES)
    got = linear_evaluation(cfg, train, test, CLASSES)
    assert got == linear_evaluation(cfg, train, test, CLASSES)
    assert abs(got - want) <= 0.05
