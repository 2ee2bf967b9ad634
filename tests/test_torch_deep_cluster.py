"""The port's DeepCluster pieces against the JAX package: Hungarian matching
(scipy and the NumPy fallback), K-means (`_assign`, `_lloyd` from given
centroids, empty clusters, planted clusters), `Trainer.map_train`, two
DeepCluster train steps on given pseudo-labels, and `pre_epoch` with the
port's K-means started from the JAX run's rows; float32 on both sides, at a
small size (a two-stage ResNet, 16x16 views, batch 8)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from ssv_tpu.data.augment import build_batch_transform
from ssv_tpu.evals import hungarian as JH
from ssv_tpu.train.base import DataInfo as JDataInfo
from ssv_tpu.train.registry import build_algorithm as jax_build_algorithm
from ssv_tpu_torch.convert import extra_state_dicts
from ssv_tpu_torch.evals import hungarian as TH
from ssv_tpu_torch.ops import kmeans as TK
from ssv_tpu_torch.train.base import DataInfo as TDataInfo
from ssv_tpu_torch.train.registry import build_algorithm
from torch_helpers import (assert_state_matches, load_jax_state, small_resnet18, t,
                           to_numpy_tree)

torch.set_num_threads(2)

# the JAX package's `ops` exports the function `kmeans` under its module's name
JK = importlib.import_module("ssv_tpu.ops.kmeans")

SIZE, BATCH, N_TRAIN = 16, 8, 60


# ---------------------------------------------------------------------------
# Hungarian matching
# ---------------------------------------------------------------------------
def _votes_cases():
    """(pred, targets, k) cases: random labels; few samples, so many vote
    counts tie; one cluster only; every target the same."""
    rs = np.random.RandomState(0)
    cases = [(rs.randint(0, 10, 500), rs.randint(0, 10, 500), 10),
             (rs.randint(0, 6, 9), rs.randint(0, 6, 9), 6),
             (np.zeros(40, int), rs.randint(0, 4, 40), 4),
             (rs.randint(0, 5, 30), np.full(30, 2), 5)]
    return cases


@pytest.mark.parametrize("path", ["scipy", "numpy"])
def test_hungarian_matches_jax(path, monkeypatch):
    """The port's copy gives the JAX module's map exactly, through scipy's
    solver and through the NumPy fallback, ties included."""
    if path == "numpy":
        monkeypatch.setattr(JH, "_lsa", None)
        monkeypatch.setattr(TH, "_lsa", None)
    else:
        assert TH._lsa is not None
    for pred, targets, k in _votes_cases():
        assert TH.hungarian_match(pred, targets, k, k) == JH.hungarian_match(pred, targets, k, k)
    rs = np.random.RandomState(1)
    for n in (3, 8, 10):
        for cost in (rs.rand(n, n), rs.randint(0, 3, (n, n)).astype(float)):
            got, want = TH._hungarian_numpy(cost), JH._hungarian_numpy(cost)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# K-means
# ---------------------------------------------------------------------------
def _blobs(n_per=40, k=4, d=8, spread=0.3, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(k, d).astype(np.float32) * 4
    x = np.concatenate([c + spread * rs.randn(n_per, d) for c in centers]).astype(np.float32)
    return x, np.repeat(np.arange(k), n_per)


def test_assign_matches_jax():
    """Assignments exactly, squared distances within 1e-5 (relative, 1e-5
    absolute), for one set of centroids and for R restarts at once (the
    JAX side vmapped over the restarts)."""
    rs = np.random.RandomState(0)
    x = rs.randn(200, 16).astype(np.float32)
    cents = rs.randn(3, 7, 16).astype(np.float32)
    a, dist = TK._assign(t(x), t(cents[0]))
    ja, jd = JK._assign(jnp.asarray(x), jnp.asarray(cents[0]))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    a, dist = TK._assign(t(x), t(cents))
    ja, jd = jax.vmap(JK._assign, in_axes=(None, 0))(jnp.asarray(x), jnp.asarray(cents))
    assert a.shape == (200, 3)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja).T)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd).T, rtol=1e-5, atol=1e-5)


def test_lloyd_matches_jax_from_given_centroids():
    """Three restarts batched from given rows of well-separated blobs: the
    same assignments as the JAX `_lloyd` of each; centroids within 1e-5,
    inertia within 1e-5 relative."""
    x, _ = _blobs()
    rows = np.array([[0, 1, 2, 3], [0, 40, 80, 120], [5, 45, 46, 130]])
    cents, assign, inertia = TK._lloyd(t(x), t(x[rows]), 12)
    for r in range(3):
        jc, ja, ji = JK._lloyd(jnp.asarray(x), jnp.asarray(x[rows[r]]), 12)
        np.testing.assert_array_equal(assign[:, r].numpy(), np.asarray(ja))
        np.testing.assert_allclose(cents[r].numpy(), np.asarray(jc), rtol=0, atol=1e-5)
        np.testing.assert_allclose(inertia[r].item(), float(ji), rtol=1e-5)


def test_lloyd_empty_cluster_keeps_its_centroid():
    """A centroid that no point is nearest to keeps its value through every
    iteration (faiss would re-seed it), on both sides."""
    x, _ = _blobs(k=3)
    init = np.stack([x[0], x[40], x[80], np.full(8, 1e3, np.float32)])
    cents, assign, _ = TK._lloyd(t(x), t(init[None]), 10)
    jc, ja, _ = JK._lloyd(jnp.asarray(x), jnp.asarray(init), 10)
    assert not (assign == 3).any()
    np.testing.assert_array_equal(cents[0, 3].numpy(), init[3])
    np.testing.assert_array_equal(np.asarray(jc)[3], init[3])
    np.testing.assert_array_equal(assign[:, 0].numpy(), np.asarray(ja))


def test_kmeans_recovers_planted_clusters():
    """Purity through `hungarian_match` as the JAX package's test checks it;
    the best restart has the least inertia of all."""
    x, labels = _blobs(n_per=100, k=3, d=2, spread=0.1)
    g = torch.Generator().manual_seed(0)
    _, assign, inertia = TK.kmeans(g, t(x), k=3, n_iters=20, n_redo=4)
    m = TH.hungarian_match(assign.numpy(), labels, 3, 3)
    assert (np.array([m[int(a)] for a in assign]) == labels).mean() > 0.99
    assert float(inertia) < 10.0
    rows = TK._init_rows(torch.Generator().manual_seed(0), len(x), 3, 4)
    _, _, every = TK._lloyd(t(x), t(x)[rows], 20)
    assert float(inertia) == every.min().item()
    assert all(len(set(r.tolist())) == 3 for r in rows)


# ---------------------------------------------------------------------------
# DeepCluster
# ---------------------------------------------------------------------------
def _config(**extra):
    cfg = helpers.mini_config("deep_cluster", batch_size=BATCH)
    cfg["compute_dtype"] = "float32"
    cfg["optimizer"]["lr"] = 0.003
    cfg["data"]["transforms"]["train"]["random_resized_crop"]["size"] = [SIZE, SIZE]
    cfg.update(extra)
    return cfg


def _pair(cfg, labels=None):
    info = (10, N_TRAIN, BATCH, N_TRAIN // BATCH)
    jalgo = jax_build_algorithm("deep_cluster", cfg, "resnet18", JDataInfo(*info))
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    if labels is not None:
        jstate = jstate.replace(extra={"pseudo_labels": jnp.asarray(labels, jnp.int32)})
    talgo = build_algorithm("deep_cluster", cfg, "resnet18", TDataInfo(*info), "cpu")
    tstate = talgo.init_state(torch.Generator().manual_seed(0))
    load_jax_state(tstate, jstate, "deep_cluster")
    return jalgo, jstate, talgo, tstate


def test_deep_cluster_two_train_steps(monkeypatch):
    """On given pseudo-labels, two steps on `aug_1` (with `aug_2` in the
    batch, unread): loss within 1e-5 relative, params 1e-4, BN statistics
    1e-5, the pseudo-labels unchanged."""
    small_resnet18(monkeypatch)
    cfg = _config()
    labels = np.random.RandomState(3).randint(0, cfg["num_classes"], N_TRAIN)
    jalgo, jstate, talgo, tstate = _pair(cfg, labels)
    fn = build_batch_transform(cfg["data"]["transforms"]["train"])
    jstep = jax.jit(jalgo.train_step)
    for s in range(2):
        u8 = np.random.RandomState(s).randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
        ks = jax.random.split(jax.random.PRNGKey(10 + s), 2 * BATCH)
        batch = {"aug_1": np.asarray(fn(ks[:BATCH], u8)),
                 "aug_2": np.asarray(fn(ks[BATCH:], u8)),
                 "index": np.random.RandomState(100 + s).permutation(N_TRAIN)[:BATCH]}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        tstate, tm = talgo.train_step(tstate, {k: t(v) for k, v in batch.items()})
        want, got = float(jm["loss"]), tm["loss"].item()
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (s, got, want)
    assert tstate.step == int(jstate.step) == 2
    assert_state_matches(tstate, jstate, "deep_cluster")
    np.testing.assert_array_equal(tstate.extra["pseudo_labels"].labels.numpy(), labels)


class _Split:
    """Stands in for the Trainer's `map_train`: fixed eval-transformed views
    of the train split in batches (the last padded with index 0)."""

    def __init__(self, images, torch_side):
        self.images, self.torch_side = images, torch_side

    def map_train(self, state, fn):
        n = len(self.images)
        idx = np.concatenate([np.arange(n), np.zeros((-n) % BATCH, int)])
        chunks = []
        for s in range(0, len(idx), BATCH):
            x = self.images[idx[s:s + BATCH]]
            out = fn(state, t(x) if self.torch_side else jnp.asarray(x))
            count = min(BATCH, n - s)
            chunks.append([(o.numpy() if self.torch_side else np.asarray(o))[:count]
                           for o in out])
        outs = [np.concatenate(parts) for parts in zip(*chunks)]
        return tuple(map(torch.from_numpy, outs)) if self.torch_side else tuple(outs)


def test_deep_cluster_pre_epoch_matches_jax(monkeypatch):
    """`pre_epoch(epoch 3)` on a split of four planted groups of images:
    with the port's K-means started from the rows JAX's `PRNGKey(3)` draws,
    the same pseudo-labels as the JAX run, exactly."""
    small_resnet18(monkeypatch)
    cfg = _config()
    k, n_redo = cfg["num_classes"], cfg["kmeans"]["n_redo"]
    jalgo, jstate, talgo, tstate = _pair(cfg)
    rs = np.random.RandomState(5)
    base = rs.randn(k, SIZE, SIZE, 3).astype(np.float32)
    images = (base[np.arange(N_TRAIN) % k]
              + 0.05 * rs.randn(N_TRAIN, SIZE, SIZE, 3)).astype(np.float32)

    keys = jax.random.split(jax.random.PRNGKey(3), n_redo)
    rows = np.stack([np.asarray(jax.random.choice(kr, N_TRAIN, shape=(k,), replace=False))
                     for kr in keys])
    drawn = []

    def jax_rows(generator, n, k_, redo):
        drawn.append((int(generator.initial_seed()), n, k_, redo))
        return torch.from_numpy(rows)

    monkeypatch.setattr(TK, "_init_rows", jax_rows)
    jstate = jalgo.pre_epoch(jstate, _Split(images, False), 3)
    tstate = talgo.pre_epoch(tstate, _Split(images, True), 3)
    assert drawn == [(3, N_TRAIN, k, n_redo)]
    want = np.asarray(jstate.extra["pseudo_labels"])
    got = tstate.extra["pseudo_labels"].labels.numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 1


def test_map_train_and_feature_fn(tmp_path, monkeypatch):
    """`Trainer.map_train` returns each output of `fn` over the train split
    in order, unpadded; `features_for(feature_fn=)` uses the given function
    in place of `embed`."""
    import yaml

    from ssv_tpu_torch.train.trainer import Trainer
    from torch_helpers import stage_fake_cifar

    small_resnet18(monkeypatch)
    monkeypatch.chdir(tmp_path)
    stage_fake_cifar(str(tmp_path / "data"), n_train=20, n_test=12)
    cfg = _config()
    cfg["data"]["root"] = str(tmp_path / "data")
    cfg["data"]["transforms"]["test"]["center_crop"]["size"] = [SIZE, SIZE]
    path = tmp_path / "dc.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    trainer = Trainer({"config": str(path), "algo": "deep_cluster", "arch": "resnet18",
                       "task": "train", "output": "run"}, device="cpu")
    images, _ = trainer.pipeline.arrays("train")

    def fn(state, x):
        return x.mean(dim=(1, 2, 3)), x.shape[0] * torch.ones(x.shape[0], dtype=torch.int64)

    means, sizes = trainer.map_train(trainer.state, fn)
    want = trainer._eval_t(None, images).mean(dim=(1, 2, 3))
    assert means.shape == (20,) and sizes.tolist() == [BATCH] * 20
    torch.testing.assert_close(means, want, rtol=0, atol=1e-6)
    fvecs, labels = trainer.features_for(trainer.state, "test",
                                         feature_fn=lambda s, x: x[:, 0, 0, :])
    assert fvecs.shape == (12, 3) and labels.shape == (12,)


def test_convert_deep_cluster_extra_leaves_sela_and_rings():
    """DeepCluster's `pseudo_labels` alone convert to the port's
    `pseudo_labels.labels`; SeLA's still need alpha, beta and best head,
    and a RingBuffer keeps its pointer."""
    from ssv_tpu.state.banks import RingBuffer

    labels = np.arange(7, dtype=np.int32) % 3
    out = extra_state_dicts({"pseudo_labels": labels}, (1, 1), {})
    assert set(out) == {"pseudo_labels"}
    assert out["pseudo_labels"]["labels"].dtype == torch.int64
    np.testing.assert_array_equal(out["pseudo_labels"]["labels"].numpy(), labels)
    sela = extra_state_dicts({"pseudo_labels": labels, "alpha": np.ones((3, 1)),
                              "beta": np.ones((4, 1)), "best_head": np.int32(2)}, (1, 1), {})
    assert set(sela) == {"self_label"} and int(sela["self_label"]["best_head"]) == 2
    ring = to_numpy_tree({"queue": RingBuffer(jnp.ones((5, 2)), jnp.asarray(3, jnp.int32))})
    out = extra_state_dicts(ring, (1, 1), {})
    assert int(out["queue"]["ptr"]) == 3 and out["queue"]["data"].shape == (5, 2)
