"""The port's BYOL, SimSiam, ReLIC and Barlow Twins against the JAX
algorithms: the towers' forwards, and two train steps from the same weights
(moved across by ssv_tpu_torch/convert.py) on the same views, in float32 on
both sides, at a small size (a two-stage ResNet, 16x16 views, batch 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from ssv_tpu.data.augment import build_batch_transform
from ssv_tpu.train.base import DataInfo as JDataInfo
from ssv_tpu.train.base import apply_train
from ssv_tpu.train.registry import build_algorithm as jax_build_algorithm
from ssv_tpu_torch.train.base import DataInfo as TDataInfo
from ssv_tpu_torch.train.registry import build_algorithm
from torch_helpers import assert_state_matches, load_jax_state, small_resnet18, t

torch.set_num_threads(2)

SIZE, BATCH = 16, 8


def _config(algo, fuse_views, **extra):
    cfg = helpers.mini_config(algo, batch_size=BATCH)
    cfg["compute_dtype"] = "float32"
    cfg["fuse_views"] = fuse_views
    # as in the SimCLR step test: at lr 0.1 two steps on 8 images amplify
    # float32 rounding past the tolerance (JAX against itself does too).
    # Barlow's loss sums 32x32 terms (about 30 here, BYOL's about 0.5), so its
    # step is larger: at 0.003 its second step breaks a max-pool tie on one
    # side and not the other (one weight off by 7e-4)
    cfg["optimizer"]["lr"] = 0.001 if algo == "barlow" else 0.003
    cfg["data"]["transforms"]["train"]["random_resized_crop"]["size"] = [SIZE, SIZE]
    cfg.update(extra)
    return cfg


def _pair(algo, cfg):
    """(JAX algorithm and state, port algorithm and state) from the same
    weights."""
    jalgo = jax_build_algorithm(algo, cfg, "resnet18", JDataInfo(10, 64, BATCH, 8))
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    talgo = build_algorithm(algo, cfg, "resnet18", TDataInfo(10, 64, BATCH, 8), "cpu")
    tstate = talgo.init_state(torch.Generator().manual_seed(0))
    load_jax_state(tstate, jstate, algo)
    return jalgo, jstate, talgo, tstate


def _views(cfg, step):
    """aug_1, aug_2 and img of one step: the JAX pipeline's train views,
    handed to both sides."""
    u8 = np.random.RandomState(step).randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    fn = build_batch_transform(cfg["data"]["transforms"]["train"])
    ks = jax.random.split(jax.random.PRNGKey(10 + step), 3 * BATCH)
    return {name: np.asarray(fn(ks[i * BATCH:(i + 1) * BATCH], u8))
            for i, name in enumerate(("aug_1", "aug_2", "img"))}


CASES = [("byol", {}), ("simsiam", {}), ("simsiam", {"target_mode": "frozen"}),
         ("relic", {}), ("barlow", {})]


@pytest.mark.parametrize("fuse_views", [False, True])
@pytest.mark.parametrize("algo,extra", CASES, ids=["byol", "simsiam-stopgrad",
                                                   "simsiam-frozen", "relic", "barlow"])
def test_two_train_steps(algo, extra, fuse_views, monkeypatch):
    small_resnet18(monkeypatch)
    cfg = _config(algo, fuse_views, **extra)
    jalgo, jstate, talgo, tstate = _pair(algo, cfg)
    jstep = jax.jit(jalgo.train_step)
    for s in range(2):
        batch = _views(cfg, s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        tstate, tm = talgo.train_step(tstate, {k: t(v) for k, v in batch.items()})
        # relative to the loss, or to 1 where the loss is nearer 0: SimSiam's
        # is a mean of cosines, about 0 at the start
        want, got = float(jm["loss"]), tm["loss"].item()
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (s, got, want)
        assert set(tm) == set(jm)
        if "tau" in jm:
            assert abs(tm["tau"].item() - float(jm["tau"])) <= 1e-7
    assert tstate.step == int(jstate.step) == 2
    # params 1e-4, BN statistics 1e-5; BYOL/ReLIC's target after the EMA too
    assert_state_matches(tstate, jstate, algo)
    if algo in ("byol", "relic"):
        assert tstate.extra["target"].encoder.conv1.weight.requires_grad is False


TOWERS = [("byol", {}), ("simsiam", {"target_mode": "frozen"}), ("barlow", {})]


@pytest.mark.parametrize("algo,extra", TOWERS, ids=["byol", "simsiam", "barlow"])
def test_towers_forward(algo, extra, monkeypatch):
    """Each tower (encoder, projector, predictor, L2 output) in train mode
    and the BN statistics it leaves, then `embed` (eval mode); SimSiam's
    online tower also as the (projector, predictor) pair of one pass."""
    small_resnet18(monkeypatch)
    cfg = _config(algo, False, **extra)
    jalgo, jstate, talgo, tstate = _pair(algo, cfg)
    x = _views(cfg, 0)["aug_1"]
    towers = [(getattr(jalgo, "online", None) or jalgo.model, "params", "batch_stats",
               tstate.model)]
    if jstate.extra:
        towers.append((jalgo.target, "target_params", "target_batch_stats",
                       tstate.extra["target"]))
    for jmod, pkey, skey, tmod in towers:
        tree = jstate.extra if pkey.startswith("target") else vars(jstate)
        want, new_stats = apply_train(jmod, tree[pkey], tree[skey], jnp.asarray(x))
        got = tmod.train()(t(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
        if skey == "batch_stats":
            jstate = jstate.replace(batch_stats=new_stats)
        else:
            jstate = jstate.replace(extra={**jstate.extra, skey: new_stats})
    assert_state_matches(tstate, jstate, algo)

    want = np.asarray(jalgo.embed(jstate, jnp.asarray(x)))
    np.testing.assert_allclose(talgo.embed(tstate, t(x)).numpy(), want, rtol=0, atol=1e-5)
    if algo == "simsiam":
        (wz, wp), _ = apply_train(jalgo.online, jstate.params, jstate.batch_stats,
                                  jnp.asarray(x), return_pair=True)
        gz, gp = tstate.model.train()(t(x), return_pair=True)
        np.testing.assert_allclose(gz.detach().numpy(), np.asarray(wz), rtol=0, atol=1e-5)
        np.testing.assert_allclose(gp.detach().numpy(), np.asarray(wp), rtol=0, atol=1e-5)
