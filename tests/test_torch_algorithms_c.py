"""The port's MoCo, SwAV and SeLA against the JAX algorithms: two train steps
from the same weights and state (moved across by ssv_tpu_torch/convert.py)
on the same views, SeLA's self-labelling sweep, its relabelling epochs, and
the `pseudolabel` batch; float32 on both sides, at a small size (a two-stage
ResNet, 16x16 views, batch 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from ssv_tpu.data.augment import build_batch_transform
from ssv_tpu.data.pipeline import DataPipeline as JDataPipeline
from ssv_tpu.state.banks import RingBuffer as JRing
from ssv_tpu.train.base import DataInfo as JDataInfo
from ssv_tpu.train.registry import build_algorithm as jax_build_algorithm
from ssv_tpu_torch.data.pipeline import DataPipeline
from ssv_tpu_torch.train.base import DataInfo as TDataInfo
from ssv_tpu_torch.train.registry import build_algorithm
from torch_helpers import assert_state_matches, load_jax_state, small_resnet18, t

torch.set_num_threads(2)

SIZE, BATCH, N_TRAIN = 16, 8, 60


def _config(algo, fuse_views=False, **extra):
    cfg = helpers.mini_config(algo, batch_size=BATCH)
    cfg["compute_dtype"] = "float32"
    cfg["fuse_views"] = fuse_views
    # as in the other step tests: a small lr keeps two steps on 8 images
    # inside float32 rounding's reach
    cfg["optimizer"]["lr"] = 0.003
    views = cfg["data"]["transforms"]["aug" if algo == "sela" else "train"]
    views["random_resized_crop"]["size"] = [SIZE, SIZE]
    cfg.update(extra)
    return cfg


def _pair(algo, cfg):
    """(JAX algorithm and state, port algorithm and state) from the same
    weights and extra state."""
    info = (10, N_TRAIN, BATCH, N_TRAIN // BATCH)
    jalgo = jax_build_algorithm(algo, cfg, "resnet18", JDataInfo(*info))
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    rs = np.random.RandomState(7)
    unit = lambda n, d: (lambda z: z / np.linalg.norm(z, axis=1, keepdims=True))(  # noqa: E731
        rs.randn(n, d).astype(np.float32))
    extra = dict(jstate.extra)
    if algo == "moco":
        # a full queue whose pointer makes the batch of 8 straddle the end
        extra["queue"] = JRing(jnp.asarray(unit(cfg["queue_size"], cfg["proj_dim"])),
                               jnp.asarray(cfg["queue_size"] - 3, jnp.int32))
    elif algo == "swav":
        extra["bank"] = JRing(jnp.asarray(unit(cfg["feature_bank_size"], cfg["proj_dim"])),
                              jnp.asarray(0, jnp.int32))
    elif algo == "sela":
        extra["pseudo_labels"] = jnp.asarray(
            rs.randint(0, cfg["num_clusters"], N_TRAIN).astype(np.int32))
        extra["beta"] = jnp.abs(extra["beta"])
    jstate = jstate.replace(extra=extra)
    talgo = build_algorithm(algo, cfg, "resnet18", TDataInfo(*info), "cpu")
    tstate = talgo.init_state(torch.Generator().manual_seed(0))
    load_jax_state(tstate, jstate, algo)
    return jalgo, jstate, talgo, tstate


def _batch(cfg, step):
    """One step's views from the JAX pipeline's train transform, handed to
    both sides: aug_1 and aug_2, or SeLA's idx and aug."""
    u8 = np.random.RandomState(step).randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    ts = cfg["data"]["transforms"]
    fn = build_batch_transform(ts.get("train", ts.get("aug")))
    ks = jax.random.split(jax.random.PRNGKey(10 + step), 2 * BATCH)
    views = [np.asarray(fn(ks[i * BATCH:(i + 1) * BATCH], u8)) for i in range(2)]
    idx = np.random.RandomState(100 + step).permutation(N_TRAIN)[:BATCH]
    return {"aug_1": views[0], "aug_2": views[1], "aug": views[0], "idx": idx}


CASES = [("moco", False), ("swav", False), ("swav", True), ("sela", False)]


@pytest.mark.parametrize("algo,fuse_views", CASES,
                         ids=["moco", "swav", "swav-fused", "sela"])
def test_two_train_steps(algo, fuse_views, monkeypatch):
    """Loss within 1e-5 relative; params 1e-4, BN statistics 1e-5; MoCo's
    key tower after the EMA and its queue (pushed across the end), SwAV's
    bank, SeLA's alpha/beta within 1e-5; the pointers, pseudo-labels and
    best head exactly."""
    small_resnet18(monkeypatch)
    cfg = _config(algo, fuse_views)
    jalgo, jstate, talgo, tstate = _pair(algo, cfg)
    jstep = jax.jit(jalgo.train_step)
    for s in range(2):
        batch = _batch(cfg, s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        tstate, tm = talgo.train_step(
            tstate, {k: t(v, torch.int64 if k == "idx" else None) for k, v in batch.items()})
        want, got = float(jm["loss"]), tm["loss"].item()
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (s, got, want)
        assert set(tm) == set(jm)
    assert tstate.step == int(jstate.step) == 2
    assert_state_matches(tstate, jstate, algo)
    if algo == "moco":
        assert int(tstate.extra["queue"].ptr) == (cfg["queue_size"] - 3 + 2 * BATCH) % \
            cfg["queue_size"]
        assert tstate.extra["target"].encoder.conv1.weight.requires_grad is False
    if algo == "sela":
        assert 0 <= int(tstate.extra["self_label"].best_head) < cfg["num_cluster_heads"]


def test_moco_key_tower_starts_as_a_copy(monkeypatch):
    small_resnet18(monkeypatch)
    talgo = build_algorithm("moco", _config("moco"), "resnet18",
                            TDataInfo(10, N_TRAIN, BATCH, 7), "cpu")
    state = talgo.init_state(torch.Generator().manual_seed(0))
    q, k = state.model.state_dict(), state.extra["target"].state_dict()
    assert q.keys() == k.keys() and all(torch.equal(q[n], k[n]) for n in q)
    assert state.extra["queue"].data.abs().sum() == 0 and int(state.extra["queue"].ptr) == 0


class _JaxStream:
    """Stands in for the JAX Trainer in a self-labelling sweep: fixed views
    of the train split in batches, the last padded with index 0."""

    def __init__(self, images):
        self.images = images

    def batches(self):
        n = len(self.images)
        idx = np.arange(n)
        idx = np.concatenate([idx, np.zeros((-n) % BATCH, idx.dtype)])
        for s in range(0, len(idx), BATCH):
            yield idx[s:s + BATCH], min(BATCH, n - s)

    def stream_train(self, state, fn):
        for idx, count in self.batches():
            yield fn(state, jnp.asarray(self.images[idx])), idx, count


class _TorchStream(_JaxStream):
    def stream_train(self, state, fn):
        for idx, count in self.batches():
            yield fn(state, t(self.images[idx])), t(idx, torch.int64), count


@pytest.mark.parametrize("mode", ["sinkhorn", "reference"])
def test_self_label_sweep(mode, monkeypatch):
    """A sweep over 60 train views (the last batch padded) from the same
    weights: the pseudo-labels exactly, alpha and beta within 1e-5 relative
    (`reference` threads them through the 8 batches)."""
    small_resnet18(monkeypatch)
    cfg = _config("sela", self_label_mode=mode)
    jalgo, jstate, talgo, tstate = _pair("sela", cfg)
    images = np.random.RandomState(3).rand(N_TRAIN, SIZE, SIZE, 3).astype(np.float32)
    jstate = jalgo._self_label(jstate, _JaxStream(images))
    tstate = talgo.self_label(tstate, _TorchStream(images))
    sl = tstate.extra["self_label"]
    want = np.asarray(jstate.extra["pseudo_labels"])
    np.testing.assert_array_equal(sl.pseudo_labels.numpy(), want)
    assert len(np.unique(want)) > 1
    for k in ("alpha", "beta"):
        np.testing.assert_allclose(getattr(sl, k).numpy(), np.asarray(jstate.extra[k]),
                                   rtol=1e-5, atol=0, err_msg=k)


@pytest.mark.parametrize("epochs,iters", [(500, 80), (2, 80), (2, 5), (10, 3)])
def test_sela_relabel_epochs(epochs, iters, monkeypatch):
    """The shipped 500 epochs / 80 iterations, the 2-epoch cut, and small
    counts: the same epochs as the JAX algorithm."""
    small_resnet18(monkeypatch)
    cfg = _config("sela", epochs=epochs, self_label_iters=iters)
    info = (10, N_TRAIN, BATCH, 7)
    jalgo = jax_build_algorithm("sela", cfg, "resnet18", JDataInfo(*info))
    talgo = build_algorithm("sela", cfg, "resnet18", TDataInfo(*info), "cpu")
    assert talgo.sl_epochs == jalgo.sl_epochs
    if (epochs, iters) == (2, 80):
        assert talgo.sl_epochs == {0, 1}


def test_pseudolabel_batch():
    """Keys, shapes and types of the `pseudolabel` batch, as the JAX
    pipeline's; `img` is the deterministic `std` view on both sides."""
    cfg = helpers.mini_config("sela", batch_size=BATCH)["data"]
    tp = DataPipeline(cfg, "cpu", synthetic_sizes=(40, 16))
    jp = JDataPipeline(cfg, synthetic_sizes=(40, 16))
    idx = np.arange(3, 3 + BATCH)
    timages, tlabels = tp.arrays("train")
    got = tp.make_batch_fn("pseudolabel")(timages, tlabels, t(idx, torch.int64),
                                          torch.Generator().manual_seed(0))
    jimages, jlabels = jp.arrays("train")
    want = jp.make_batch_fn("pseudolabel")(jimages, jlabels, jnp.asarray(idx),
                                           jax.random.PRNGKey(0))
    assert set(got) == set(want) == {"idx", "img", "aug", "label"}
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
    assert got["aug"].dtype == got["img"].dtype == torch.float32
    np.testing.assert_allclose(got["img"].numpy(), np.asarray(want["img"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))
    # the eval transform of a config with `std` and no `test` is `std`
    x = tp.make_eval_transform()(None, timages[t(idx, torch.int64)])
    np.testing.assert_allclose(x.numpy(), got["img"].numpy(), rtol=0, atol=0)
