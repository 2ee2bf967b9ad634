"""The port's BYOL, SimSiam, Barlow Twins and ReLIC losses and its EMA
update against the JAX package's, on the same numpy inputs."""

import jax
import numpy as np
import pytest
import torch

from ssv_tpu.objectives import losses as JL
from ssv_tpu.state.ema import ema_update as jax_ema_update
from ssv_tpu_torch.objectives import losses as TL
from ssv_tpu_torch.state.ema import ema_update
from ssv_tpu_torch.utils.schedules import cosine_ramp
from torch_helpers import t

torch.set_num_threads(2)


def _unit(rs, n, d):
    z = rs.randn(n, d).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


def _close(got, want, tol=1e-6):
    assert abs(got - want) <= tol * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("step", [0, 7, 20])
def test_ema_update(step):
    """Over a tree of parameters, at a tau of the cosine ramp."""
    rs = np.random.RandomState(step)
    shapes = [(16, 3, 3, 3), (16,), (32, 16)]
    target = [rs.randn(*s).astype(np.float32) for s in shapes]
    online = [rs.randn(*s).astype(np.float32) for s in shapes]
    tau = cosine_ramp(step, 20, 0.99, 1.0)
    want = jax_ema_update(target, online, jax.numpy.float32(tau))
    got = [t(a) for a in target]
    ema_update(got, [t(a) for a in online], tau)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        ema_update(got, got[:1], tau)


def test_byol_mse():
    rs = np.random.RandomState(0)
    o1, o2, t1, t2 = (_unit(rs, 12, 16) for _ in range(4))
    want = float(JL.byol_mse(o1, o2, t1, t2))
    _close(TL.byol_mse(t(o1), t(o2), t(t1), t(t2)).item(), want)
    # the targets carry no gradient
    tt1 = t(t1).requires_grad_(True)
    TL.byol_mse(t(o1).requires_grad_(True), t(o2), tt1, t(t2)).backward()
    assert tt1.grad is None


def test_simsiam_neg_cosine():
    rs = np.random.RandomState(1)
    o, z = _unit(rs, 12, 16), _unit(rs, 12, 16)
    _close(TL.simsiam_neg_cosine(t(o), t(z)).item(), float(JL.simsiam_neg_cosine(o, z)))
    tz = t(z).requires_grad_(True)
    TL.simsiam_neg_cosine(t(o).requires_grad_(True), tz).backward()
    assert tz.grad is None


@pytest.mark.parametrize("normalize", [False, True])
def test_barlow_twins(normalize):
    rs = np.random.RandomState(2)
    zi, zj = (rs.randn(24, 32).astype(np.float32) for _ in range(2))
    want = float(JL.barlow_twins(zi, zj, off_diagonal_weight=0.005, normalize=normalize))
    got = TL.barlow_twins(t(zi), t(zj), off_diagonal_weight=0.005, normalize=normalize)
    _close(got.item(), want)


@pytest.mark.parametrize("corrected", [False, True])
@pytest.mark.parametrize("temperature,normalize", [(1.0, True), (0.1, True), (0.5, False)])
def test_relic_loss(corrected, temperature, normalize):
    rs = np.random.RandomState(3)
    zi, zj, zo = (rs.randn(12, 16).astype(np.float32) for _ in range(3))
    kw = dict(temperature=temperature, alpha=0.5, normalize=normalize, corrected=corrected)
    want = float(JL.relic_loss(zi, zj, zo, **kw))
    _close(TL.relic_loss(t(zi), t(zj), t(zo), **kw).item(), want)
