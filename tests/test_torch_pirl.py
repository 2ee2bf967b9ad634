"""The port's PIRL pieces against the JAX package: `pirl_nce` in both
`negatives_from` modes, the per-sample bank, the `PirlNet` jigsaw forward,
and two PIRL train steps with JAX's draws injected; float32 on both sides,
at a small size (a two-stage ResNet, 16x16 views cut into four 8x8 patches,
batch 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from ssv_tpu.data.augment import build_batch_transform
from ssv_tpu.objectives.losses import pirl_nce as jax_pirl_nce
from ssv_tpu.state import banks as JB
from ssv_tpu.train.base import DataInfo as JDataInfo
from ssv_tpu.train.registry import build_algorithm as jax_build_algorithm
from ssv_tpu_torch.convert import extra_state_dicts
from ssv_tpu_torch.objectives.losses import pirl_nce
from ssv_tpu_torch.state import banks as TB
from ssv_tpu_torch.train.base import DataInfo as TDataInfo
from ssv_tpu_torch.train.registry import build_algorithm
from torch_helpers import (assert_state_matches, load_jax_state, small_resnet18, t,
                           to_numpy_tree)

torch.set_num_threads(2)

SIZE, PATCH, BATCH, N_TRAIN = 16, 8, 8, 60


def _unit(rs, n, d):
    z = rs.randn(n, d).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("negatives_from", ["features", "memory"])
@pytest.mark.parametrize("normalize", [True, False])
def test_pirl_nce_matches_jax(negatives_from, normalize):
    """Loss within 1e-5 relative, its gradients with respect to the image
    and the patch features within 1e-5."""
    rs = np.random.RandomState(0)
    vi, vp = rs.randn(6, 16).astype(np.float32), rs.randn(6, 16).astype(np.float32)
    mpos, mneg = _unit(rs, 6, 16), _unit(rs, 20, 16)
    kw = dict(temperature=0.07, loss_weight=0.3, normalize=normalize,
              negatives_from=negatives_from)
    want, (gi, gp) = jax.value_and_grad(
        lambda a, b: jax_pirl_nce(a, b, jnp.asarray(mpos), jnp.asarray(mneg), **kw),
        argnums=(0, 1))(jnp.asarray(vi), jnp.asarray(vp))
    ti, tp = t(vi).requires_grad_(), t(vp).requires_grad_()
    got = pirl_nce(ti, tp, t(mpos), t(mneg), **kw)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), rtol=0, atol=1e-5)


def test_pirl_nce_memory_mode_has_no_repulsion():
    """With `negatives_from="memory"` the negative block holds no feature, so
    each feature's gradient is a multiple of its own bank row (attraction
    alone); with "features" it is not. A bad mode raises."""
    rs = np.random.RandomState(1)
    mpos, mneg = t(_unit(rs, 5, 8)), t(_unit(rs, 12, 8))
    for mode, parallel in (("memory", True), ("features", False)):
        vi = t(rs.randn(5, 8).astype(np.float32)).requires_grad_()
        vp = t(rs.randn(5, 8).astype(np.float32)).requires_grad_()
        pirl_nce(vi, vp, mpos, mneg, normalize=False, negatives_from=mode).backward()
        for g in (vi.grad, vp.grad):
            along = (g * mpos).sum(dim=1, keepdim=True) * mpos
            assert torch.allclose(g, along, atol=1e-6) == parallel, mode
    with pytest.raises(ValueError, match="negatives_from"):
        pirl_nce(vi, vp, mpos, mneg, negatives_from="bank")


# ---------------------------------------------------------------------------
# the bank
# ---------------------------------------------------------------------------
def test_sample_bank_set_and_update_match_jax():
    """Writes of normalized rows and the EMA (not normalized again) within
    1e-6 of the JAX bank; rows outside the indices untouched."""
    rs = np.random.RandomState(2)
    idx = rs.permutation(30)[:7]
    v1, v2 = rs.randn(7, 16).astype(np.float32), 5 * rs.randn(7, 16).astype(np.float32)
    jbank = JB.sample_bank_set(JB.sample_bank_init(30, 16), jnp.asarray(idx), jnp.asarray(v1))
    jbank = JB.sample_bank_update(jbank, jnp.asarray(idx), jnp.asarray(v2), 0.5)
    bank = TB.SampleBank(30, 16)
    TB.sample_bank_set(bank, t(idx), t(v1))
    np.testing.assert_allclose(bank.data[t(idx)].norm(dim=1).numpy(), 1.0, rtol=1e-6)
    TB.sample_bank_update(bank, t(idx), t(v2), 0.5)
    np.testing.assert_allclose(bank.data.numpy(), np.asarray(jbank.data), rtol=0, atol=1e-6)
    assert (bank.data.norm(dim=1)[t(idx)] < 1 - 1e-3).any()
    others = np.setdiff1d(np.arange(30), idx)
    assert bank.data[t(others)].abs().sum() == 0


def test_sample_negatives_excludes_the_batch_without_repeats():
    """Rows are told by their values (row i is all i): the draw never holds
    a batch row or a row twice, and takes `num_negatives` of them."""
    bank = TB.SampleBank(50, 4)
    bank.data.copy_(torch.arange(50.0)[:, None].expand(50, 4))
    g = torch.Generator().manual_seed(0)
    seen = set()
    for s in range(20):
        idx = torch.randperm(50, generator=g)[:10]
        rows = TB.sample_negatives(g, bank, idx, 40)
        got = rows[:, 0].long().tolist()
        assert len(got) == len(set(got)) == 40
        assert not set(got) & set(idx.tolist())
        seen |= set(got)
    assert len(seen) == 50


# ---------------------------------------------------------------------------
# PirlNet and PIRL
# ---------------------------------------------------------------------------
def _config(**extra):
    cfg = helpers.mini_config("pirl", batch_size=BATCH)
    cfg["compute_dtype"] = "float32"
    cfg["patch_size"] = PATCH
    cfg["optimizer"]["lr"] = 0.003
    cfg["data"]["transforms"]["train"]["random_resized_crop"]["size"] = [SIZE, SIZE]
    cfg.update(extra)
    return cfg


def _pair(cfg):
    """(JAX algorithm and state, port algorithm and state) from the same
    weights and a bank of random unit rows."""
    info = (10, N_TRAIN, BATCH, N_TRAIN // BATCH)
    jalgo = jax_build_algorithm("pirl", cfg, "resnet18", JDataInfo(*info, image_size=SIZE))
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    bank = _unit(np.random.RandomState(7), N_TRAIN, cfg["proj_dim"])
    jstate = jstate.replace(extra={"bank": JB.SampleBank(jnp.asarray(bank))})
    talgo = build_algorithm("pirl", cfg, "resnet18", TDataInfo(*info), "cpu")
    tstate = talgo.init_state(torch.Generator().manual_seed(0))
    load_jax_state(tstate, jstate, "pirl")
    return jalgo, jstate, talgo, tstate


def _views(cfg, step):
    u8 = np.random.RandomState(step).randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    fn = build_batch_transform(cfg["data"]["transforms"]["train"])
    ks = jax.random.split(jax.random.PRNGKey(10 + step), 2 * BATCH)
    return np.asarray(fn(ks[:BATCH], u8)), np.asarray(fn(ks[BATCH:], u8))


@pytest.mark.parametrize("perm", [None, [0, 1, 2, 3], [2, 0, 3, 1]],
                         ids=["no-perm", "identity", "shuffled"])
def test_pirlnet_forward_matches_flax(perm, monkeypatch):
    """Train mode: image and jigsaw features within 1e-5, and the BN
    running statistics after the encoder's two passes (image, then the 32
    patches) within 1e-5; eval mode: the image features within 1e-5."""
    small_resnet18(monkeypatch)
    cfg = _config()
    jalgo, jstate, talgo, tstate = _pair(cfg)
    img, patches = _views(cfg, 0)
    jperm = None if perm is None else jnp.asarray(perm)
    (jimg, jpatch), upd = jalgo.model.apply(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        jnp.asarray(img), jnp.asarray(patches), perm=jperm, train=True,
        mutable=["batch_stats"])
    tstate.model.train()
    timg, tpatch = tstate.model(t(img), t(patches), None if perm is None else torch.tensor(perm))
    assert tpatch.shape == (BATCH, cfg["proj_dim"]) and tpatch.dtype == torch.float32
    np.testing.assert_allclose(timg.detach().numpy(), np.asarray(jimg), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tpatch.detach().numpy(), np.asarray(jpatch), rtol=0, atol=1e-5)
    assert_state_matches(tstate, jstate.replace(batch_stats=upd["batch_stats"]), "pirl")
    want = jalgo.embed(jstate.replace(batch_stats=upd["batch_stats"]), jnp.asarray(img))
    got = talgo.embed(tstate, t(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _jax_draws(key, idx, num_patches, num_negatives):
    """The permutation and negative rows JAX's `train_step` draws from
    `key`: split, permutation, uniform scores with -inf at the batch, top-k."""
    k_perm, k_neg = jax.random.split(key)
    perm = jax.random.permutation(k_perm, num_patches)
    scores = jax.random.uniform(k_neg, (N_TRAIN,)).at[jnp.asarray(idx)].set(-jnp.inf)
    _, neg = jax.lax.top_k(scores, num_negatives)
    return np.asarray(perm), np.asarray(neg)


@pytest.mark.parametrize("negatives_from", ["features", "memory"])
def test_pirl_two_train_steps(negatives_from, monkeypatch):
    """Two steps against `jax.jit(train_step)`, with JAX's permutation and
    negatives injected into `PIRL.draw`: loss within 1e-5 relative, params
    1e-4, BN statistics after the double encoder pass 1e-5, the bank (EMA of
    the batch's rows) 1e-6."""
    small_resnet18(monkeypatch)
    cfg = _config(loss_fn={"normalize": True, "temperature": 0.07, "loss_weight": 0.5,
                           "negatives_from": negatives_from})
    jalgo, jstate, talgo, tstate = _pair(cfg)
    jstep = jax.jit(jalgo.train_step)
    perms = []
    for s in range(2):
        aug_1, aug_2 = _views(cfg, s)
        idx = np.random.RandomState(100 + s).permutation(N_TRAIN)[:BATCH]
        key = jax.random.PRNGKey(s + 1)
        perm, neg = _jax_draws(key, idx, cfg["num_patches"], cfg["num_negatives"])
        perms.append(perm.tolist())
        monkeypatch.setattr(talgo, "draw",
                            lambda g, bank, i, p=perm, n=neg: (t(p), bank.data[t(n)]))
        batch = {"aug_1": aug_1, "aug_2": aug_2, "index": idx}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        tstate, tm = talgo.train_step(tstate, {k: t(v) for k, v in batch.items()}, None)
        want, got = float(jm["loss"]), tm["loss"].item()
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (s, got, want)
    assert perms[0] != [0, 1, 2, 3] or perms[1] != [0, 1, 2, 3]
    assert tstate.step == int(jstate.step) == 2
    assert_state_matches(tstate, jstate, "pirl")
    np.testing.assert_allclose(tstate.extra["bank"].data.numpy(),
                               np.asarray(jstate.extra["bank"].data), rtol=0, atol=1e-6)


def test_pirl_draw_and_defaults():
    """The port's own draw: a permutation of the patches and bank rows
    outside the batch; `negatives_from` defaults to "features"."""
    cfg = _config()
    talgo = build_algorithm("pirl", cfg, "resnet18", TDataInfo(10, N_TRAIN, BATCH, 7), "cpu")
    assert talgo.loss_cfg["negatives_from"] == "features"
    bank = TB.SampleBank(N_TRAIN, 4)
    bank.data.copy_(torch.arange(float(N_TRAIN))[:, None].expand(N_TRAIN, 4))
    idx = torch.arange(BATCH)
    perm, rows = talgo.draw(torch.Generator().manual_seed(0), bank, idx)
    assert sorted(perm.tolist()) == [0, 1, 2, 3]
    assert rows.shape == (cfg["num_negatives"], 4) and rows[:, 0].min() >= BATCH


def test_pirl_pre_train_fills_the_bank_from_f_proj(monkeypatch):
    """`pre_train` writes every row from `features_for(feature_fn=)` with
    the raw f_proj outputs, normalized, as the JAX `pre_train` does."""
    small_resnet18(monkeypatch)
    cfg = _config()
    jalgo, jstate, talgo, tstate = _pair(cfg)
    images = np.random.RandomState(4).rand(N_TRAIN, SIZE, SIZE, 3).astype(np.float32)

    class Split:
        def __init__(self, torch_side):
            self.torch_side = torch_side

        def features_for(self, state, split="train", feature_fn=None, progress_desc=None):
            assert split == "train" and feature_fn is not None
            if self.torch_side:
                return feature_fn(state, t(images)), None
            return np.asarray(feature_fn(state, jnp.asarray(images))), None

    jstate = jalgo.pre_train(jstate, Split(False))
    tstate = talgo.pre_train(tstate, Split(True))
    np.testing.assert_allclose(tstate.extra["bank"].data.numpy(),
                               np.asarray(jstate.extra["bank"].data), rtol=0, atol=1e-6)


def test_convert_pirl_extra_keeps_ring_buffers():
    """A `SampleBank` converts to the port's bank `data` alone; a
    `RingBuffer` under the same name keeps its pointer."""
    data = np.arange(12, dtype=np.float32).reshape(4, 3)
    out = extra_state_dicts(to_numpy_tree({"bank": JB.SampleBank(jnp.asarray(data))}), (1, 1), {})
    assert set(out["bank"]) == {"data"}
    np.testing.assert_array_equal(out["bank"]["data"].numpy(), data)
    ring = to_numpy_tree({"bank": JB.RingBuffer(jnp.asarray(data), jnp.asarray(2, jnp.int32))})
    out = extra_state_dicts(ring, (1, 1), {})
    assert set(out["bank"]) == {"data", "ptr"} and int(out["bank"]["ptr"]) == 2
