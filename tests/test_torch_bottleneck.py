"""The port's Bottleneck ResNets (ResNet-50/101/152, ResNeXt, Wide ResNet)
and `tiny` against the flax modules, on the same weights (moved across by
ssv_tpu_torch/convert.py) and the same inputs: train- and eval-mode
features, the BN statistics, one step's gradients, the init, every
factory's shapes, converted Towers, and the CLI on `-m resnet50`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import helpers
from ssv_tpu.models import registry as JREG
from ssv_tpu.models import resnet as JR
from ssv_tpu.models.tiny import TinyEncoder as JTiny
from ssv_tpu.train.base import DataInfo as JDataInfo
from ssv_tpu.train.base import apply_eval, apply_train, init_module
from ssv_tpu.train.registry import build_algorithm as jax_build_algorithm
from ssv_tpu_torch import convert
from ssv_tpu_torch.convert import resnet_state_dict
from ssv_tpu_torch.models import registry as TREG
from ssv_tpu_torch.models import resnet as TR
from ssv_tpu_torch.train.base import DataInfo as TDataInfo
from ssv_tpu_torch.train.registry import build_algorithm
from torch_helpers import (load_jax_state, small_resnet18, stage_fake_cifar, strict_jit, t,
                           to_numpy_tree)

torch.set_num_threads(2)

STAGES = (2, 1)   # a block without a downsample in layer1, a strided one in layer2
SETTINGS = {"plain": {}, "plain-7x7-stem": {"reduce_bottom_conv": False},
            "grouped": {"groups": 4, "width_per_group": 4},
            "wide": {"width_per_group": 128}}


def _pair(kw, dtype, size, seed=0):
    """A flax Bottleneck ResNet at `dtype` and the port's, same weights."""
    kw = {"reduce_bottom_conv": True, **kw}
    x = np.random.RandomState(seed).rand(8, size, size, 3).astype(np.float32)
    jnet = JR.ResNet(block=JR.Bottleneck, stage_sizes=STAGES, dtype=dtype, **kw)
    params, bstats = init_module(jax.random.PRNGKey(seed), jnet, jnp.asarray(x))
    params, bstats = to_numpy_tree(params), to_numpy_tree(bstats)
    net = TR.ResNet(TR.Bottleneck, STAGES, **kw)
    net.load_state_dict(resnet_state_dict(params, bstats, STAGES))
    return jnet, params, bstats, net, x


def _stats_gap(net, want_sd):
    got = net.state_dict()
    return max(float((got[k] - w).abs().max()) for k, w in want_sd.items()
               if k.endswith(("running_mean", "running_var")))


@pytest.mark.parametrize("setting", SETTINGS)
def test_bottleneck_train_eval_and_gradients(setting, monkeypatch):
    """float32: train-mode features and the BN statistics they leave within
    1e-5, then eval-mode features within 1e-5. The gradients of one loss
    (the mean of the features times fixed random weights) in float64 on
    both sides (the features rounded to float32 on both, as each module
    returns them), within 1e-6 of each tensor's largest: float32
    gradients are ill-conditioned here, the wide net's miss float64's by
    4 % in the port and 8 % in JAX."""
    size = 32 if setting == "plain-7x7-stem" else 16
    jnet, params, bstats, net, x = _pair(SETTINGS[setting], jnp.float32, size)
    want, new_bstats = jax.jit(lambda p, b, v: apply_train(jnet, p, b, v))(
        params, bstats, jnp.asarray(x))
    got = net.train()(t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert _stats_gap(net, resnet_state_dict(params, to_numpy_tree(new_bstats), STAGES)) <= 1e-5

    want = jax.jit(lambda p, b, v: apply_eval(jnet, p, b, v))(params, new_bstats, jnp.asarray(x))
    with torch.no_grad():
        got = net.eval()(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    r = np.random.RandomState(1).randn(8, 512)
    with jax.enable_x64(True):
        jnet64 = jnet.clone(dtype=jnp.float64, param_dtype=jnp.float64)
        p64, b64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), (params, bstats))

        def loss(p):
            feats, _ = jnet64.apply({"params": p, "batch_stats": b64}, jnp.asarray(x, jnp.float64),
                                    train=True, mutable=["batch_stats"])
            return jnp.mean(feats.astype(jnp.float64) * r)

        grads = to_numpy_tree(jax.jit(jax.grad(loss))(p64))
    monkeypatch.setattr(convert, "_t", lambda a: torch.from_numpy(np.array(a, np.float64)))
    net = net.double().train()
    net.load_state_dict(resnet_state_dict(params, bstats, STAGES))
    (net(torch.from_numpy(x).double()) * torch.from_numpy(r)).mean().backward()
    want_grads = resnet_state_dict(grads, bstats, STAGES)
    names = [name for name, _ in net.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(params))
    for name, p in net.named_parameters():
        w = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("setting", ["plain", "grouped", "wide"])
def test_bottleneck_bf16_under_autocast(setting):
    """bf16: the port under torch.autocast("cpu", bfloat16) against flax at
    dtype bfloat16 compiled with excess precision off. BN normalises in
    float32 on both sides but not by the same formula, so an activation can
    round to the next bf16 step, and the stack carries that on: features
    within 2 bf16 steps at their largest magnitude (2**-6 of it; readings
    1 step, 0.0078 of 1.24-1.35), the BN statistics within 1e-2 (readings
    7.8e-4-1.2e-3)."""
    jnet, params, bstats, net, x = _pair(SETTINGS[setting], jnp.bfloat16, 16)
    want, new_bstats = strict_jit(lambda p, b, v: apply_train(jnet, p, b, v),
                                  params, bstats, jnp.asarray(x))
    want = np.asarray(want)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = net.train()(t(x))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 2 ** -6 * np.abs(want).max()
    assert _stats_gap(net, resnet_state_dict(params, to_numpy_tree(new_bstats), STAGES)) <= 1e-2


@pytest.mark.parametrize("zero_init", [False, True])
def test_bottleneck_init_matches_flax(zero_init):
    """Kaiming fan-out normal convs: a grouped 3x3 kernel (w, w/g, 3, 3) has
    fan-out 9 w in torch as flax's (3, 3, w/g, w) has, so both draw with std
    sqrt(2 / (9 w)); BN scales 1 and biases 0, except each block's third BN
    scale, 0 under zero_init_residual."""
    kw = {"groups": 32, "width_per_group": 4, "reduce_bottom_conv": True,
          "zero_init_residual": zero_init}
    jnet = JR.ResNet(block=JR.Bottleneck, stage_sizes=STAGES, dtype=jnp.float32, **kw)
    params, bstats = init_module(jax.random.PRNGKey(0), jnet, jnp.zeros((2, 16, 16, 3)))
    want = resnet_state_dict(to_numpy_tree(params), to_numpy_tree(bstats), STAGES)
    net = TR.ResNet(TR.Bottleneck, STAGES, **kw)
    net.init_weights(torch.Generator().manual_seed(0))
    conv = net.layer2[0].conv2
    assert conv.groups == 32 and tuple(conv.weight.shape) == (256, 8, 3, 3)
    assert torch.nn.init._calculate_fan_in_and_fan_out(conv.weight)[1] == 9 * 256
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        w = want[k].numpy()
        if v.dim() == 4:
            fan_out = v.shape[0] * v.shape[2] * v.shape[3]
            std = (2.0 / fan_out) ** 0.5
            assert abs(v.std().item() / std - 1) < 0.15, k
            assert abs(w.std() / std - 1) < 0.15, k
        else:
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
    zeroed = sorted(k for k, v in net.state_dict().items()
                    if k.endswith(".weight") and v.dim() == 1 and not v.any())
    assert zeroed == (["layer1.0.bn3.weight", "layer1.1.bn3.weight", "layer2.0.bn3.weight"]
                      if zero_init else [])


def test_basic_block_refuses_groups_and_width():
    with pytest.raises(ValueError, match="groups=1, base_width=64"):
        TR.ResNet(TR.BasicBlock, (1, 1), groups=2)
    with pytest.raises(ValueError, match="groups=1, base_width=64"):
        TR.ResNet(TR.BasicBlock, (1, 1), width_per_group=128)


FACTORIES = {"resnet50": 23_500_352, "resnet101": 42_492_480, "resnet152": 58_136_128,
             "resnext50": 22_972_224, "resnext101": 86_734_656,
             "wide_resnet50": 66_826_560, "wide_resnet101": 124_830_016}


@pytest.mark.parametrize("arch", FACTORIES)
def test_factory_shapes_match_flax(arch, monkeypatch):
    """Every parameter and BN statistic of each factory (with the CIFAR
    stem), by the converted flax name, has flax's shape (flax's from
    `jax.eval_shape` of `init`, which traces and does not compile; the
    port's on the meta device); the parameter count is torchvision's less
    the fc layer and the 7,680 weights the 3x3 stem saves."""
    jnet = JREG.NETWORKS[arch]["net"](reduce_bottom_conv=True)
    shapes = jax.eval_shape(lambda: jnet.init({"params": jax.random.PRNGKey(0)},
                                              jnp.zeros((1, 32, 32, 3)), train=False))
    monkeypatch.setattr(convert, "_t", lambda a: torch.empty(a.shape, device="meta"))
    want = resnet_state_dict(shapes["params"], shapes["batch_stats"], JREG.NETWORKS[arch]
                             ["net"]().stage_sizes)
    with torch.device("meta"):
        net, dim = TREG.build_encoder(arch, {"reduce_bottom_conv": True})
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    n = sum(p.numel() for p in net.parameters())
    assert n == FACTORIES[arch] == sum(int(np.prod(x.shape))
                                       for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert dim == JREG.NETWORKS[arch]["dim"] == 2048


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [32, 15])
def test_tiny_encoder_matches_flax(size, dtype):
    """TinyEncoder in train mode (features and BN statistics), then eval
    mode, at 32x32 and at an odd 15x15 (flax's `SAME` padding: 0 before and
    1 after at an even size, 1 and 1 at an odd one). bf16 under
    torch.autocast against flax's bf16 convs and float32 BNs (excess
    precision off): the BN outputs are float32 on both sides, so the
    features agree within 1e-6 in float32; in bf16 a conv output can round
    to the other bf16 step (the two sum in other orders), so within one
    bf16 step of the largest feature, 2**-8 of it (reading 1.1e-4 of
    0.56)."""
    x = np.random.RandomState(size).rand(8, size, size, 3).astype(np.float32)
    jnet = JTiny(dtype=jnp.dtype(dtype))
    params, bstats = init_module(jax.random.PRNGKey(0), jnet, jnp.asarray(x))
    params, bstats = to_numpy_tree(params), to_numpy_tree(bstats)
    net, dim = TREG.build_encoder("tiny", {})
    assert dim == 64
    net.load_state_dict(resnet_state_dict(params, bstats, ()))
    autocast = torch.autocast("cpu", dtype=torch.bfloat16, enabled=dtype == "bfloat16")
    want, new_bstats = strict_jit(lambda p, b, v: apply_train(jnet, p, b, v),
                                  params, bstats, jnp.asarray(x))
    with torch.no_grad(), autocast:
        got = net.train()(t(x))
    assert got.dtype == torch.float32 and got.shape == (8, 64)
    tol = 1e-6 if dtype == "float32" else 2 ** -8 * float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)
    assert _stats_gap(net, resnet_state_dict(params, to_numpy_tree(new_bstats), ())) <= tol
    want = strict_jit(lambda p, b, v: apply_eval(jnet, p, b, v), params, new_bstats,
                      jnp.asarray(x))
    with torch.no_grad(), autocast:
        got = net.eval()(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def test_tiny_init_and_width():
    """flax Conv defaults (lecun normal, truncated, fan-in 9 x in; zero
    bias), `features` sets the width, and the ResNet-only keys are
    accepted and ignored."""
    net, dim = TREG.build_encoder("tiny", {"features": 48, "reduce_bottom_conv": False,
                                           "zero_init_residual": True, "patch_size": 4})
    net.init_weights(torch.Generator().manual_seed(0))
    assert dim == 48 and net(torch.rand(4, 16, 16, 3)).shape == (4, 48)
    for conv in (net.conv1, net.conv2):
        std = (1.0 / conv.weight[0].numel()) ** 0.5
        assert abs(conv.weight.std().item() / std - 1) < 0.15
        assert conv.weight.abs().max().item() <= 2 * std / 0.8796 + 1e-6
        assert not conv.bias.any()


ALGOS = ["simclr", "moco", "byol", "relic", "simsiam", "barlow", "swav", "sela", "dino",
         "pirl", "deep_cluster"]


@pytest.mark.parametrize("algo", ALGOS)
def test_converted_state_loads_strict_on_tiny(algo):
    """Every algorithm's JAX state on `tiny` (its Towers, extra towers and
    buffers) converts and loads into the port's with strict=True, and the
    two models give the same features in float32."""
    cfg = helpers.mini_config(algo, batch_size=8)
    cfg["compute_dtype"] = "float32"
    jalgo = jax_build_algorithm(algo, cfg, "tiny", JDataInfo(10, 64, 8, 8))
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    talgo = build_algorithm(algo, cfg, "tiny", TDataInfo(10, 64, 8, 8), "cpu")
    tstate = talgo.init_state(torch.Generator().manual_seed(0))
    load_jax_state(tstate, jstate, algo)
    x = np.random.RandomState(0).rand(8, 16, 16, 3).astype(np.float32)
    want = np.asarray(jalgo.embed(jstate, jnp.asarray(x)))
    np.testing.assert_allclose(talgo.embed(tstate, t(x)).numpy(), want, rtol=0, atol=1e-5)


def test_converted_tower_loads_strict_on_resnet50(monkeypatch):
    """A SimCLR Tower on `resnet50` (cut to two Bottleneck stages) and BYOL's
    with its EMA target: converted and loaded with strict=True, the same
    features in float32."""
    small_resnet18(monkeypatch, "resnet50")
    for algo in ("simclr", "byol"):
        cfg = helpers.mini_config(algo, batch_size=8)
        cfg["compute_dtype"] = "float32"
        jalgo = jax_build_algorithm(algo, cfg, "resnet50", JDataInfo(10, 64, 8, 8))
        jstate = jalgo.init_state(jax.random.PRNGKey(0))
        talgo = build_algorithm(algo, cfg, "resnet50", TDataInfo(10, 64, 8, 8), "cpu")
        tstate = talgo.init_state(torch.Generator().manual_seed(0))
        load_jax_state(tstate, jstate, algo)
        assert isinstance(tstate.model.encoder.layer1[0], TR.Bottleneck)
        x = np.random.RandomState(0).rand(8, 16, 16, 3).astype(np.float32)
        want = np.asarray(jalgo.embed(jstate, jnp.asarray(x)))
        np.testing.assert_allclose(talgo.embed(tstate, t(x)).numpy(), want, rtol=0, atol=1e-5)


def test_cli_trains_resnet50_then_linear_eval(tmp_path, monkeypatch):
    """`-m resnet50 -a simclr` through the CLI on the CPU (the Bottleneck
    ResNet cut to two stages, 16x16 views, batch 16, bf16 autocast): train
    with KNN, checkpoints and the probe, then `-t linear_eval -l` on it."""
    from ssv_tpu_torch import main as cli

    small_resnet18(monkeypatch, "resnet50")
    stage_fake_cifar(str(tmp_path / "data"), n_train=64, n_test=32)
    monkeypatch.chdir(tmp_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "simclr.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(epochs=1, eval_every=1)
    cfg["linear_eval"].update(epochs=2, batch_size=16)
    cfg["data"].update(batch_size=16, root=str(tmp_path / "data"))
    cfg["data"]["transforms"]["train"]["random_resized_crop"]["size"] = [16, 16]
    cfg["data"]["transforms"]["test"]["center_crop"]["size"] = [16, 16]
    path = tmp_path / "simclr.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    argv = ["-c", str(path), "-m", "resnet50", "-a", "simclr", "--device", "cpu"]

    trainer = cli.main([*argv, "-t", "train", "-o", "run"])
    run = tmp_path / "outputs" / "simclr" / "resnet50" / "run"
    assert (run / "latest").is_file() and (run / "best_model").is_file()
    assert isinstance(trainer.state.model.encoder.layer2[0], TR.Bottleneck)
    losses = trainer.epoch_stats[0]["losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert 0.0 <= trainer.linear_eval_stats["accuracy"] <= 1.0
    lin = cli.main([*argv, "-t", "linear_eval", "-o", "lin", "-l", str(run)])
    assert 0.0 <= lin.linear_eval_stats["accuracy"] <= 1.0
