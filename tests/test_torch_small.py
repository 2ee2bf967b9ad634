"""The port's losses, schedules and KNN against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssv_tpu.objectives import losses as JL
from ssv_tpu.ops.knn import knn_label_agreement as jax_knn
from ssv_tpu.utils.schedules import lr_schedule as jax_lr_schedule
from ssv_tpu_torch.evals.knn import compute_neighbor_accuracy
from ssv_tpu_torch.objectives import losses as TL
from ssv_tpu_torch.ops.knn import cosine_topk
from ssv_tpu_torch.utils.schedules import lr_schedule
from torch_helpers import t

torch.set_num_threads(2)


@pytest.mark.parametrize("temperature,normalize", [(0.5, True), (1.0, False), (0.1, True)])
def test_nt_xent(temperature, normalize):
    rs = np.random.RandomState(0)
    zi, zj = (rs.randn(12, 16).astype(np.float32) for _ in range(2))
    want = float(JL.nt_xent(zi, zj, temperature=temperature, normalize=normalize))
    got = TL.nt_xent(t(zi), t(zj), temperature=temperature, normalize=normalize).item()
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_softmax_cross_entropy_and_l2():
    rs = np.random.RandomState(1)
    logits = rs.randn(10, 7).astype(np.float32) * 3
    labels = rs.randint(0, 7, 10).astype(np.int32)
    want = float(JL.softmax_cross_entropy(logits, labels))
    assert abs(TL.softmax_cross_entropy(t(logits), t(labels)).item() - want) <= 1e-6
    np.testing.assert_allclose(TL.l2_normalize(t(logits)).numpy(),
                               np.asarray(JL.l2_normalize(logits)), atol=1e-6)


@pytest.mark.parametrize("scheduler", [
    {"name": "cosine", "warmup_epochs": 1},
    {"name": "cosine", "warmup_epochs": 0},
    {"name": "multistep", "milestones": [1, 2], "gamma": 0.1},
    {"name": "none"},
])
def test_lr_schedule_every_step(scheduler):
    opt = {"name": "sgd", "lr": 2.0}
    jfn = jax_lr_schedule(opt, scheduler, epochs=3, steps_per_epoch=7)
    tfn = lr_schedule(opt, scheduler, epochs=3, steps_per_epoch=7)
    for step in range(3 * 7 + 1):
        assert abs(tfn(step) - float(jfn(step))) <= 1e-7 * max(1.0, float(jfn(step)))


def test_knn_accuracy_matches_on_tie_free_features():
    rs = np.random.RandomState(2)
    labels = rs.randint(0, 5, 300).astype(np.int32)
    feats = (rs.randn(300, 32) + 2.0 * np.eye(5, 32)[labels]).astype(np.float32)
    want = float(jax_knn(jnp.asarray(feats), jnp.asarray(labels), k=20, chunk=128))
    got = compute_neighbor_accuracy(t(feats), t(labels, torch.int64), k=20)
    assert abs(got - want) <= 1e-6
    assert 0.2 < got < 1.0
    # chunking does not change the neighbors, and self is never one
    f = t(feats) / t(feats).norm(dim=1, keepdim=True)
    _, a = cosine_topk(f, f, 20, exclude_offset=0, chunk=64)
    _, b = cosine_topk(f, f, 20, exclude_offset=0, chunk=1000)
    assert torch.equal(a, b)
    assert not (a == torch.arange(300)[:, None]).any()


def test_cosine_ramp():
    from ssv_tpu.utils.schedules import cosine_ramp as jax_ramp
    from ssv_tpu_torch.utils.schedules import cosine_ramp

    for step in range(0, 25):
        want = float(jax_ramp(step, 20, 0.99, 1.0))
        assert abs(cosine_ramp(step, 20, 0.99, 1.0) - want) <= 1e-7
