"""The port's ResNet, head and SimCLR step against the flax modules and the
JAX SimCLR, on the same weights (moved across by ssv_tpu_torch/convert.py)
and the same inputs, in float32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from ssv_tpu.data.augment import build_batch_transform
from ssv_tpu.models import heads as JH
from ssv_tpu.models import resnet as JR
from ssv_tpu.train.algorithms.common import Tower as JTower
from ssv_tpu.train.algorithms.simclr import SimCLR as JSimCLR
from ssv_tpu.train.base import DataInfo as JDataInfo
from ssv_tpu.train.base import apply_eval, apply_train, init_module
from ssv_tpu_torch.convert import resnet_state_dict, tower_state_dict
from ssv_tpu_torch.models import heads as TH
from ssv_tpu_torch.models import resnet as TR
from ssv_tpu_torch.train.algorithms.common import Tower as TTower
from ssv_tpu_torch.train.algorithms.simclr import SimCLR as TSimCLR
from ssv_tpu_torch.train.base import DataInfo as TDataInfo
from torch_helpers import t, to_numpy_tree

torch.set_num_threads(2)


def _stats_of(model):
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def test_resnet18_forward_train_and_eval():
    x = np.random.RandomState(0).rand(4, 32, 32, 3).astype(np.float32)
    jnet = JR.resnet18(reduce_bottom_conv=True, dtype=jnp.float32)
    params, bstats = init_module(jax.random.PRNGKey(0), jnet, jnp.asarray(x))
    params, bstats = to_numpy_tree(params), to_numpy_tree(bstats)

    net = TR.resnet18(reduce_bottom_conv=True)
    net.load_state_dict(resnet_state_dict(params, bstats, (2, 2, 2, 2)))

    want, new_bstats = jax.jit(lambda p, b, v: apply_train(jnet, p, b, v))(
        params, bstats, jnp.asarray(x))
    net.train()
    got = net(t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # running statistics after one train-mode forward (biased variance, as flax)
    want_sd = resnet_state_dict(params, to_numpy_tree(new_bstats), (2, 2, 2, 2))
    for k, v in _stats_of(net).items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)

    want = jax.jit(lambda p, b, v: apply_eval(jnet, p, b, v))(params, new_bstats, jnp.asarray(x))
    net.eval()
    with torch.no_grad():
        got = net(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_init_scales_match_flax():
    """kaiming fan-out normal convs; lecun truncated-normal Dense, zero bias."""
    x = jnp.zeros((2, 16, 16, 3))
    jtower = JTower(encoder=JR.ResNet(block=JR.BasicBlock, stage_sizes=(1, 1),
                                      reduce_bottom_conv=True, dtype=jnp.float32),
                    proj=JH.simclr_projection(128, 64, dtype=jnp.float32))
    params, bstats = init_module(jax.random.PRNGKey(1), jtower, x)
    want = tower_state_dict(to_numpy_tree(params), to_numpy_tree(bstats), (1, 1),
                            {"proj": (0, 1)})
    tower = TTower(TR.ResNet(TR.BasicBlock, (1, 1), reduce_bottom_conv=True),
                   TH.simclr_projection(128, 64))
    tower.init_weights(torch.Generator().manual_seed(0))
    for k, v in tower.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        w = want[k].numpy()
        if v.dim() >= 2:
            assert abs(v.std().item() / w.std() - 1) < 0.15, k
            if v.dim() == 2:   # truncated at 2 std
                assert v.abs().max().item() <= 2 * (1 / v.shape[1]) ** 0.5 / 0.8796 + 1e-6
        else:
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)


@pytest.mark.parametrize("fuse_views", [False, True])
def test_simclr_two_train_steps(fuse_views):
    size = 16
    cfg = helpers.mini_config("simclr", batch_size=8)
    cfg["compute_dtype"] = "float32"
    cfg["fuse_views"] = fuse_views
    # with 8 images and lr 0.1 the second step is ill-conditioned: JAX against
    # itself, params perturbed by 4e-6, differs by 1e-2 after two steps
    cfg["optimizer"]["lr"] = 0.003
    cfg["data"]["transforms"]["train"]["random_resized_crop"]["size"] = [size, size]

    jalgo = JSimCLR(cfg, "resnet18", JDataInfo(10, 64, 8, 8))
    jalgo.model = JTower(encoder=JR.ResNet(block=JR.BasicBlock, stage_sizes=(1, 1),
                                           reduce_bottom_conv=True, dtype=jnp.float32),
                         proj=JH.simclr_projection(128, 16, dtype=jnp.float32))
    jstate = jalgo.init_state(jax.random.PRNGKey(0))

    talgo = TSimCLR(cfg, "resnet18", TDataInfo(10, 64, 8, 8), "cpu")
    talgo.model = TTower(TR.ResNet(TR.BasicBlock, (1, 1), reduce_bottom_conv=True),
                         TH.simclr_projection(128, 16))
    tstate = talgo.init_state(torch.Generator().manual_seed(0))
    tstate.model.load_state_dict(tower_state_dict(
        to_numpy_tree(jstate.params), to_numpy_tree(jstate.batch_stats), (1, 1),
        {"proj": (0, 1)}))

    # the views are the JAX pipeline's output, handed to both sides
    u8 = np.random.RandomState(0).randint(0, 256, (8, size, size, 3), dtype=np.uint8)
    views = jax.jit(build_batch_transform(cfg["data"]["transforms"]["train"]))
    jstep = jax.jit(jalgo.train_step)
    for s in range(2):
        ks = jax.random.split(jax.random.PRNGKey(10 + s), 16)
        batch = {"aug_1": views(ks[:8], u8), "aug_2": views(ks[8:], u8)}
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        tstate, tm = talgo.train_step(
            tstate, {k: t(np.asarray(v)) for k, v in batch.items()})
        want, got = float(jm["loss"]), tm["loss"].item()
        assert abs(got - want) <= 1e-5 * abs(want), (s, got, want)
    assert tstate.step == 2

    want_sd = tower_state_dict(to_numpy_tree(jstate.params),
                               to_numpy_tree(jstate.batch_stats), (1, 1), {"proj": (0, 1)})
    got_sd = tstate.model.state_dict()
    for k, w in want_sd.items():
        tol = 1e-5 if k.endswith(("running_mean", "running_var")) else 1e-4
        np.testing.assert_allclose(got_sd[k].numpy(), w.numpy(), rtol=0, atol=tol,
                                   err_msg=k)


def _dtype_pair(arch, cfg, monkeypatch):
    """The JAX algorithm's encoder (from its `encoder_cfg`) and the port's
    algorithm with the same weights; SimCLR on a two-stage ResNet, DINO on
    a 2-layer ViT."""
    from ssv_tpu.models.registry import build_encoder as jax_build_encoder
    from ssv_tpu.train.registry import build_algorithm as jax_build_algorithm
    from ssv_tpu_torch.convert import vit_state_dict
    from ssv_tpu_torch.train.registry import build_algorithm
    from torch_helpers import small_resnet18

    small_resnet18(monkeypatch)
    algo = "dino" if arch == "vit" else "simclr"
    jalgo = jax_build_algorithm(algo, cfg, arch, JDataInfo(10, 64, 8, 8))
    jnet, _ = jax_build_encoder(arch, jalgo.encoder_cfg())
    x = np.random.RandomState(0).rand(4, 16, 16, 3).astype(np.float32)
    params, bstats = init_module(jax.random.PRNGKey(0), jnet, jnp.asarray(x))
    params, bstats = to_numpy_tree(params), to_numpy_tree(bstats)
    talgo = build_algorithm(algo, cfg, arch, TDataInfo(10, 64, 8, 8), "cpu")
    encoder = (talgo.student if arch == "vit" else talgo.model).encoder
    encoder.load_state_dict(vit_state_dict(params) if arch == "vit"
                            else resnet_state_dict(params, bstats, (1, 1)))
    return jnet, params, bstats, talgo, encoder, x


@pytest.mark.parametrize("arch", ["resnet18", "vit"])
def test_encoder_dtype_float32_runs_outside_autocast(arch, monkeypatch):
    """`encoder: {dtype: float32}` without `compute_dtype`: the JAX encoder
    computes in float32 while its heads stay bf16. The port's encoder, run
    inside the algorithm's bf16 autocast, gives the JAX float32 features
    within 1e-5 (bf16 would miss by about 1e-2), and the algorithm keeps
    its bf16 autocast for the heads."""
    cfg = helpers.mini_config("dino" if arch == "vit" else "simclr", batch_size=8)
    cfg["encoder"] = {**cfg["encoder"], "dtype": "float32"}
    if arch == "vit":
        cfg["encoder"].update(num_global_patches=16, num_local_patches=4)
    jnet, params, bstats, talgo, encoder, x = _dtype_pair(arch, cfg, monkeypatch)
    assert talgo.autocast_dtype == torch.bfloat16
    if arch == "vit":
        want = jnet.apply({"params": params}, jnp.asarray(x), train=True)
    else:
        want, _ = apply_train(jnet, params, bstats, jnp.asarray(x))
    encoder.train()
    with talgo.autocast():
        got = encoder(t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_encoder_dtype_bfloat16_under_float32_compute(monkeypatch):
    """`encoder: {dtype: bfloat16}` with `compute_dtype: float32`: the
    encoder's convolutions run in bf16 though the algorithm has no autocast
    (its heads stay float32), and the features come out float32."""
    cfg = helpers.mini_config("simclr", batch_size=8)
    cfg["compute_dtype"] = "float32"
    cfg["encoder"] = {**cfg["encoder"], "dtype": "bfloat16"}
    _, _, _, talgo, encoder, x = _dtype_pair("resnet18", cfg, monkeypatch)
    assert talgo.autocast_dtype is None
    seen = []
    encoder.conv1.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    head = []
    talgo.model.proj.register_forward_pre_hook(
        lambda m, i: head.append(torch.is_autocast_enabled("cpu")))
    with talgo.autocast():
        z = talgo.model(t(x))
    assert seen == [torch.bfloat16] and head == [False]
    assert z.dtype == torch.float32


@pytest.mark.parametrize("key,value", [("dtype", "float16"), ("dtype", "bf16"),
                                       ("param_dtype", "bfloat16")])
@pytest.mark.parametrize("arch", ["resnet18", "vit"])
def test_bad_encoder_dtype_raises(arch, key, value):
    from ssv_tpu_torch.models.registry import build_encoder

    cfg = helpers.mini_config("dino")["encoder"] if arch == "vit" else {}
    with pytest.raises(ValueError, match=key):
        build_encoder(arch, {**cfg, key: value})
