"""The port's DINO against the JAX package: its loss, schedules, the
adam/adamw chain with the gradient clamp and scheduled decay, two train
steps and the per-epoch teacher EMA from the same weights (moved across by
ssv_tpu_torch/convert.py) on the same multi-crop batch, `embed_backbone`,
exact resume and the CLI, in float32 on both sides, at a small size (a
2-layer ViT of width 32, or a two-stage ResNet; 16x16 global and 8x8 local
crops, batch 4)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import helpers
from ssv_tpu.objectives.losses import dino_loss as jax_dino_loss
from ssv_tpu.train.base import DataInfo as JDataInfo
from ssv_tpu.train.optim import get_optimizer as jax_get_optimizer
from ssv_tpu.train.registry import build_algorithm as jax_build_algorithm
from ssv_tpu.utils import schedules as JS
from ssv_tpu_torch import main as cli
from ssv_tpu_torch.objectives.losses import dino_loss
from ssv_tpu_torch.train.base import DataInfo as TDataInfo
from ssv_tpu_torch.train.optim import OptaxAdam, get_optimizer
from ssv_tpu_torch.train.registry import build_algorithm
from ssv_tpu_torch.train.trainer import Trainer
from ssv_tpu_torch.utils import schedules as TS
from torch_helpers import (_jax_state_dicts, assert_state_matches, load_jax_state,
                           small_resnet18, stage_fake_cifar, t)

torch.set_num_threads(2)

B, VG, VL, K = 4, 2, 2, 16


def test_dino_loss_and_gradient():
    """Value and gradient (with respect to the student) to 1e-5, the
    teacher carrying no gradient."""
    rs = np.random.RandomState(0)
    teacher = rs.randn(B, VG, K).astype(np.float32)
    student = rs.randn(B, VG + VL, K).astype(np.float32)
    center = rs.randn(1, K).astype(np.float32)
    want, gs = jax.value_and_grad(
        lambda s: jax_dino_loss(jnp.asarray(teacher), s, 0.1, 0.05, jnp.asarray(center)))(
        jnp.asarray(student))
    s, tt = t(student).requires_grad_(True), t(teacher).requires_grad_(True)
    got = dino_loss(tt, s, 0.1, 0.05, t(center))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs), atol=1e-5, rtol=0)
    assert tt.grad is None


@pytest.mark.parametrize("epoch", [0, 15, 30, 31])
def test_dino_schedules(epoch):
    """The teacher temperature (warmup 0.04 -> 0.07 over 30 epochs) equal in
    float32; the weight-decay ramp (cosine 0.04 -> 0.4 over 100 epochs)
    within 1e-6 relative, since numpy's and XLA's float32 cosines may differ
    in the last bit."""
    temp = dict(lower=0.04, upper=0.07, warmup_epochs=30)
    wd = dict(lower=0.04, upper=0.4, epochs=100)
    assert TS.dino_teacher_temp(epoch, **temp) == float(JS.dino_teacher_temp(epoch, **temp))
    assert TS.dino_weight_decay(epoch, **wd) == pytest.approx(
        float(JS.dino_weight_decay(epoch, **wd)), rel=1e-6, abs=0)
    if epoch >= 30:
        assert TS.dino_teacher_temp(epoch, **temp) == float(np.float32(0.07))


# name, weight_decay_fn, grad_clip
CHAINS = [("adamw", True, 3.0), ("adam", True, 3.0), ("adamw", False, None),
          ("sgd", True, 3.0)]


def _ten_steps(name, scheduled, clip, make_optimizer=get_optimizer):
    """Ten steps of an optimizer from `make_optimizer` against the JAX
    package's optax chain on the same gradients (a third of them past the
    clamp), with the per-step cosine lr and the epoch-wise decay ramp over 4
    steps an epoch, and against the same chain in float64 numpy (adam and
    adamw). Returns (optimizer, {name: (port, optax, float64)})."""
    rs = np.random.RandomState(1)
    shapes = {"w": (6, 5), "b": (5,), "u": (3, 2, 2)}
    init = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (3 * rs.randn(*s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(10)]
    cfg = {"name": name, "lr": 0.05, "epsilon": 1e-6, "weight_decay": 0.04}
    lr_cfg = dict(optimizer_cfg=cfg, scheduler_cfg={"name": "cosine", "warmup_epochs": 1},
                  epochs=3, steps_per_epoch=4)
    jwd = (lambda s: JS.cosine_ramp(s // 4, 3, 0.04, 0.4)) if scheduled else None
    twd = (lambda s: TS.cosine_ramp(s // 4, 3, 0.04, 0.4)) if scheduled else (lambda s: 0.04)
    lr_fn = TS.lr_schedule(**lr_cfg)

    tx = jax_get_optimizer(cfg, JS.lr_schedule(**lr_cfg), weight_decay_fn=jwd, grad_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jp)
    update = jax.jit(tx.update)
    params = {k: torch.nn.Parameter(t(v)) for k, v in init.items()}
    opt, sched = make_optimizer(cfg, list(params.values()), lr_fn,
                                weight_decay_fn=twd if scheduled else None, grad_clip=clip)
    exact = {k: v.astype(np.float64) for k, v in init.items()}
    mu = {k: np.zeros_like(v) for k, v in exact.items()}
    nu = {k: np.zeros_like(v) for k, v in exact.items()}
    for step, g in enumerate(grads):
        upd, opt_state = update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for k, p in params.items():
            p.grad = t(g[k])
        opt.step()
        sched.step()
        wd, lr = twd(step), lr_fn(step)
        for k, p in exact.items():
            gk = g[k].astype(np.float64)
            gk = np.clip(gk, -clip, clip) if clip else gk
            gk = gk + wd * p if name == "adam" else gk
            mu[k] = 0.9 * mu[k] + 0.1 * gk
            nu[k] = 0.999 * nu[k] + 0.001 * gk * gk
            u = mu[k] / (1 - 0.9 ** (step + 1)) / (
                np.sqrt(nu[k] / (1 - 0.999 ** (step + 1))) + 1e-6)
            exact[k] = p - lr * (u + wd * p if name == "adamw" else u)
    return opt, {k: (p.detach().numpy(), np.asarray(jp[k]), exact[k])
                 for k, p in params.items()}


@pytest.mark.parametrize("name,scheduled,clip", CHAINS,
                         ids=["adamw", "adam", "adamw-constant", "sgd-clip"])
def test_optimizer_chain_matches_optax(name, scheduled, clip):
    """The port's optimizer against the optax chain over ten steps:
    parameters within 1e-6 (`_ten_steps`); sgd is torch's SGD with the
    clamp and the scheduled decay from its step pre-hook."""
    opt, out = _ten_steps(name, scheduled, clip)
    assert type(opt) is (torch.optim.SGD if name == "sgd" else OptaxAdam)
    for k, (port, optax, _) in out.items():
        np.testing.assert_allclose(port, optax, atol=1e-6, rtol=0, err_msg=k)
    if scheduled:
        assert [g["count"] for g in opt.param_groups] == [10]


def _chain_pre_hook(weight_decay_fn, grad_clip):
    """The chain's extras on the host, for an optimizer of torch's that reads
    host numbers: the clamp, then `weight_decay` set to wd(count) with
    `count` a host int in the param group, advanced each step."""
    def hook(optimizer, args, kwargs):
        for group in optimizer.param_groups:
            if grad_clip is not None:
                grads = [p.grad for p in group["params"] if p.grad is not None]
                torch._foreach_clamp_min_(grads, -grad_clip)
                torch._foreach_clamp_max_(grads, grad_clip)
            if weight_decay_fn is not None:
                group["weight_decay"] = weight_decay_fn(group["count"])
                group["count"] += 1
    return hook


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_torch_adam_misses_optax_by_its_bias_correction(name):
    """Why adam and adamw are `OptaxAdam` and not torch.optim.Adam/AdamW
    with the same pre-hook: torch's end further than 1e-6 from optax's
    parameters over the ten steps (1.61e-6 adam, 1.79e-6 adamw), though
    within 1e-6 of the chain in float64, because optax takes 1 - b**t in
    float32, where 0.999 is 1.3e-5 off relative to 1 - b2; `OptaxAdam`
    follows optax."""
    def torch_adam(cfg, params, lr_fn, weight_decay_fn, grad_clip):
        cls = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
        opt = cls(params, lr=1.0, eps=cfg["epsilon"], weight_decay=cfg["weight_decay"])
        for group in opt.param_groups:
            group["count"] = 0
        opt.register_step_pre_hook(_chain_pre_hook(weight_decay_fn, grad_clip))
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_fn)

    _, out = _ten_steps(name, True, 3.0, torch_adam)
    assert max(np.abs(port - optax).max() for port, optax, _ in out.values()) > 1e-6
    assert max(np.abs(port - exact).max() for port, _, exact in out.values()) < 1e-6
    _, ours = _ten_steps(name, True, 3.0)
    assert max(np.abs(port - optax).max() for port, optax, _ in ours.values()) <= 1e-6


def _config(arch, **extra):
    cfg = helpers.mini_config("dino", epochs=2)
    cfg["compute_dtype"] = "float32"
    cfg["optimizer"]["lr"] = 1e-3
    cfg["data"]["multicrop_config"]["global_size"] = [16, 16]
    cfg["encoder"].update(num_global_patches=16, num_attention_heads=2)
    cfg.update(extra)
    return cfg


def _pair(arch, cfg, spe=1):
    """(JAX DINO and state, port DINO and state) from the same weights,
    teacher and center."""
    info = (10, B * spe, B, spe)
    jalgo = jax_build_algorithm("dino", cfg, arch, JDataInfo(*info))
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    talgo = build_algorithm("dino", cfg, arch, TDataInfo(*info), "cpu")
    tstate = talgo.init_state(torch.Generator().manual_seed(0))
    load_jax_state(tstate, jstate, "dino")
    return jalgo, jstate, talgo, tstate


def _batch(step):
    rs = np.random.RandomState(10 + step)
    return {"global_1": rs.rand(B, VG, 16, 16, 3).astype(np.float32),
            "global_2": rs.rand(B, VG, 16, 16, 3).astype(np.float32),
            "local_1": rs.rand(B, VL, 8, 8, 3).astype(np.float32),
            "local_2": rs.rand(B, VL, 8, 8, 3).astype(np.float32)}


# arch, config switches; one step an epoch, so the second step is epoch 2's
# (its teacher temperature, decay and, under freeze_last_layer: 1, fc_out
# unfrozen)
# The last is the shapes100 ResNet-18 row's recipe: both switches at once,
# with configs/dino.yaml's optimizer (AdamW, lr 1e-4, epsilon 1e-6) as the
# row runs it. Its updates are about lr in size, so the test holds each
# parameter's change against JAX's relative to that change, not only the
# parameters' values.
with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "dino.yaml")) as _f:
    SHIPPED_OPTIMIZER = yaml.safe_load(_f)["optimizer"]
STEPS = [("vit", {}), ("resnet18", {}), ("vit", {"teacher_update": "step"}),
         ("vit", {"freeze_last_layer": 1}), ("vit", {"center_init": "zeros"}),
         ("resnet18", {"teacher_update": "step", "center_init": "zeros",
                       "optimizer": SHIPPED_OPTIMIZER})]


@pytest.mark.parametrize("arch,extra", STEPS,
                         ids=["vit-fused", "resnet-unfused", "teacher-step", "freeze-1",
                              "center-zeros", "resnet-step-zeros"])
def test_two_train_steps_and_post_epoch(arch, extra, monkeypatch):
    """Loss within 1e-5 relative at each step; after each step the teacher
    is the per-step EMA at JAX's lambda of the updated student under
    `teacher_update: step` and untouched otherwise; after two steps each
    student parameter's change within 1e-2 of JAX's (relative to its norm),
    and, after the epoch's teacher EMA, the student's and teacher's params
    within 1e-5 for the ViT and 1e-4 for the ResNet (as the other ResNet step
    tests hold them: Adam divides by sqrt(nu) + 1e-6, so a conv-weight
    gradient that cancels to near 1e-6 carries float32 rounding into its
    step), BN statistics and the center within 1e-5. The ViT fuses its views
    (default), the ResNet runs one forward per view."""
    small_resnet18(monkeypatch)
    cfg = _config(arch, **extra)
    jalgo, jstate, talgo, tstate = _pair(arch, cfg)
    assert talgo.fuse == jalgo.fuse == (arch == "vit")
    if extra.get("center_init") == "zeros":
        assert tstate.extra["center"].value.eq(0).all()
    fc_out = [p.detach().clone() for p in tstate.model.proj.fc_out.parameters()]
    student0, jstudent0 = _params(tstate.model), _jax_state_dicts(jstate, "dino")["model"]
    jstep = jax.jit(jalgo.train_step)
    for s in range(2):
        batch = _batch(s)
        teacher_prev = _params(tstate.extra["teacher"])
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        tstate, tm = talgo.train_step(tstate, {k: t(v) for k, v in batch.items()})
        want, got = float(jm["loss"]), tm["loss"].item()
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (s, got, want)
        _assert_teacher_step(jalgo, s, teacher_prev, tstate)
        if s == 0 and extra.get("freeze_last_layer"):
            assert all(torch.equal(a, b) for a, b in
                       zip(fc_out, tstate.model.proj.fc_out.parameters()))
    jstudent = _jax_state_dicts(jstate, "dino")["model"]
    for k, p in _params(tstate.model).items():
        moved = p.double() - student0[k].double()
        want = jstudent[k].double() - jstudent0[k].double()
        assert (moved - want).norm() <= 1e-2 * want.norm(), (k, moved.norm(), want.norm())
    jstate = jalgo.post_epoch(jstate, 1)
    tstate = talgo.post_epoch(tstate, 1)
    assert tstate.step == int(jstate.step) == 2
    assert_state_matches(tstate, jstate, "dino", param_tol=1e-5 if arch == "vit" else 1e-4)
    assert not torch.equal(fc_out[0], tstate.model.proj.fc_out.v)


def _params(module):
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def _assert_teacher_step(jalgo, step, teacher_prev, tstate):
    """The teacher after train step `step`: under `teacher_update: step`,
    lambda * its value before + (1 - lambda) * the updated student, lambda
    from JAX's cosine over the run's steps, to float32 rounding; under the
    per-epoch EMA, unchanged."""
    student = _params(tstate.model)
    if jalgo.teacher_update == "step":
        lbd = torch.tensor(float(JS.cosine_ramp(step, jalgo.total_steps, jalgo.lambda_lower,
                                                jalgo.lambda_upper)))
        assert lbd < 1
    for k, p in _params(tstate.extra["teacher"]).items():
        if jalgo.teacher_update == "step":
            want = lbd * teacher_prev[k] + (1 - lbd) * student[k]
            assert not torch.equal(p, teacher_prev[k]), k
        else:
            want = teacher_prev[k]
        np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=0, atol=1e-7, err_msg=k)


def test_teacher_stats_take_the_last_trained_epochs_temperature(monkeypatch):
    """The JAX probe reads the temperature one epoch ahead (at the end of
    epoch e it takes epoch e's index, the next epoch's); the port takes the
    epoch its last step ran in, so at the end of epoch 2 it equals JAX
    evaluated at the end of epoch 1."""
    cfg = _config("vit", temp_warmup_epochs=4)
    jalgo, jstate, talgo, tstate = _pair("vit", cfg, spe=3)
    outputs = np.random.RandomState(0).randn(12, K).astype(np.float32)
    tstate.step = 6                                   # the end of epoch 2
    got = talgo.teacher_stats(tstate, t(outputs))
    want = jalgo.teacher_stats(jstate.replace(step=jnp.asarray(3)), outputs)
    ahead = jalgo.teacher_stats(jstate.replace(step=jnp.asarray(6)), outputs)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k
    assert got["ent_frac"] != pytest.approx(ahead["ent_frac"], rel=1e-3)


@pytest.mark.parametrize("algo", ["byol", "simsiam", "dino"])
def test_embed_backbone(algo, monkeypatch):
    """The encoder's features before any head, as the JAX `embed_backbone`
    gives them, to 1e-5 (eval mode: BN running statistics)."""
    small_resnet18(monkeypatch)
    if algo == "dino":
        cfg, arch = _config("vit"), "vit"
    else:
        cfg, arch = helpers.mini_config(algo), "resnet18"
        cfg["compute_dtype"] = "float32"
    info = (10, 8, 4, 2)
    jalgo = jax_build_algorithm(algo, cfg, arch, JDataInfo(*info))
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    talgo = build_algorithm(algo, cfg, arch, TDataInfo(*info), "cpu")
    tstate = talgo.init_state(torch.Generator().manual_seed(0))
    load_jax_state(tstate, jstate, algo)
    x = np.random.RandomState(0).rand(3, 16, 16, 3).astype(np.float32)
    want = np.asarray(jalgo.embed_backbone(jstate, jnp.asarray(x)))
    got = talgo.embed_backbone(tstate, t(x))
    assert got.shape == want.shape == (3, 32 if algo == "dino" else 128)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_dino_rejects_bad_recipe_flags():
    info = TDataInfo(10, 8, 4, 2)
    for key, value in (("teacher_update", "sometimes"), ("center_init", "ones")):
        with pytest.raises(ValueError, match=key):
            build_algorithm("dino", _config("vit", **{key: value}), "vit", info, "cpu")


# --------------------------------------------------------------------------
# the Trainer and the CLI
# --------------------------------------------------------------------------

class Stop(Exception):
    pass


def _trainer(tmp_path, monkeypatch, output, **args):
    """A DINO ViT Trainer on a tiny fake CIFAR-10 (64 train, 32 test images;
    16x16 globals, 16x16 test crops, batch 16: 4 steps an epoch), 2 epochs."""
    monkeypatch.chdir(tmp_path)
    data = tmp_path / "data"
    if not data.exists():
        stage_fake_cifar(str(data), n_train=64, n_test=32)
    cfg = _config("vit")
    cfg["data"].update(root=str(data), batch_size=16)
    cfg["data"]["multicrop_config"]["test_transforms"]["center_crop"]["size"] = [16, 16]
    path = tmp_path / "dino.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return Trainer({"config": str(path), "algo": "dino", "arch": "vit", "task": "train",
                    "output": output, "load": None, **args}, device="cpu")


def _tensors(trainer):
    s = trainer.state
    out = {f"model.{k}": v for k, v in s.model.state_dict().items()}
    for name, module in s.extra.items():
        out.update({f"{name}.{k}": v for k, v in module.state_dict().items()})
    for i, st in s.optimizer.state_dict()["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in st.items()})
    out["generator"] = trainer.generator.get_state()
    return out


def test_exact_resume_dino(tmp_path, monkeypatch):
    """Two epochs straight against one epoch, a stop, a new Trainer with
    `load`, and the second epoch: the same losses, student, teacher (after
    the epoch-1 EMA), center, Adam moments, optimizer count, generator state
    and probe accuracy, bit for bit."""
    straight = _trainer(tmp_path, monkeypatch, "straight")
    acc = straight.train()
    cut = _trainer(tmp_path, monkeypatch, "cut")

    def stop_at_epoch_2(state, trainer, epoch):
        if epoch == 2:
            raise Stop
        return state

    cut.algorithm.pre_epoch = stop_at_epoch_2
    with pytest.raises(Stop):
        cut.train_safe()
    resumed = _trainer(tmp_path, monkeypatch, "resumed", load=cut.output_dir)
    assert resumed.start_epoch == 2
    assert resumed.train() == acc
    assert resumed.epoch_stats[0]["losses"] == straight.epoch_stats[1]["losses"]
    a, b = _tensors(straight), _tensors(resumed)
    assert a.keys() == b.keys() and {"teacher.encoder.cls_embedding",
                                     "center.value"} <= a.keys()
    for k in a:
        assert torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k], k
    assert resumed.state.step == straight.state.step == 8
    assert b["optimizer.0.step"] == 8
    assert [g["count"] for g in resumed.state.optimizer.param_groups] == [8]
    assert not torch.equal(resumed.state.extra["teacher"].encoder.cls_embedding,
                           resumed.state.model.encoder.cls_embedding)


def test_cli_dino_vit_train_then_inference_tasks(tmp_path, monkeypatch):
    """configs/dino.yaml at its widths, cut to 2 layers and one epoch on the
    staged fake CIFAR (16x16 globals, batch 16) and in the default bf16
    autocast: `train` (KNN, checkpoints, the probe on the 1,024-wide student
    output), then `linear_eval -l` and `get_features -l` on its checkpoint."""
    stage_fake_cifar(str(tmp_path / "data"))
    monkeypatch.chdir(tmp_path)
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                           "dino.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(epochs=1, eval_every=1)
    cfg["encoder"].update(num_encoder_layers=2, num_global_patches=16)
    cfg["linear_eval"].update(epochs=2)
    cfg["data"].update(batch_size=16, root=str(tmp_path / "data"))
    mc = cfg["data"]["multicrop_config"]
    mc["global_size"] = [16, 16]
    mc["test_transforms"]["center_crop"]["size"] = [16, 16]
    path = tmp_path / "dino.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))

    def drive(*argv):
        return cli.main(["-c", str(path), "-m", "vit", "-a", "dino", "--device", "cpu", *argv])

    trainer = drive("-t", "train", "-o", "run")
    run = tmp_path / "outputs" / "dino" / "vit" / "run"
    assert (run / "latest").is_file() and (run / "best_model").is_file()
    losses = trainer.epoch_stats[0]["losses"]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert 0.0 <= trainer.linear_eval_stats["accuracy"] <= 1.0
    assert drive("-t", "linear_eval", "-o", "lin", "-l", str(run)).linear_eval_stats
    drive("-t", "get_features", "-o", "feat", "-l", str(run))
    feat = tmp_path / "outputs" / "dino" / "vit" / "feat"
    for name, shape in [("train_fvecs", (128, 1024)), ("train_gt", (128,)),
                        ("test_fvecs", (256, 1024)), ("test_gt", (256,))]:
        assert np.load(feat / f"{name}.npy").shape == shape, name
