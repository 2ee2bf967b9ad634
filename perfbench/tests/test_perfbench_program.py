"""`program.py` against the port's own optimizers and DINO, on the CPU:
`first_grad` gives back the gradient as each optimizer of the port's
factory took it (clamped, with its decay taken out) and raises on an
optimizer it does not read; the reference's plain `common.adam` steps as
the port's `OptaxAdam` does; `load_weights` puts a marked buffer (DINO's
`center.value`) into the program, raises on one the program lacks, and a
step of the port's DINO on a tiny ViT then reads back a finite first
gradient that is non-zero wherever the student's loss reached."""

import json
import types
from pathlib import Path

import pytest
import torch
import yaml

from perfbench import inputs, program
from perfbench.reference import common

ROOT = Path(__file__).resolve().parents[2]
CLIP = 2.0**-4   # exact in float32


def _wd(step: int) -> float:
    return 0.04 + 0.1 * step


# (name in the port's factory, weight_decay_fn, grad_clip)
OPTIMIZERS = {"sgd": ("sgd", None, None), "sgd_scheduled_decay": ("sgd", _wd, None),
              "adam": ("adam", None, None), "adam_scheduled_decay": ("adam", _wd, CLIP),
              "adamw_clip_scheduled_decay": ("adamw", _wd, CLIP)}


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(6, 4)
        self.norm = torch.nn.LayerNorm(4)
        self.unused = torch.nn.Parameter(torch.ones(3))


def _stepped(optimizer):
    """A tiny module's one step from known gradients (every parameter but
    `unused`, some elements past the clamp) with `optimizer`, made as
    `Algorithm.make_optimizer` makes it; (trainer, starting weights, the
    gradients as the optimizer should have taken them)."""
    from ssv_tpu_torch.train.optim import get_optimizer

    name, wd_fn, clip = OPTIMIZERS[optimizer]
    torch.manual_seed(3)
    model = _Tiny()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_()
    weights = {f"model.{n}": p.detach().clone() for n, p in model.named_parameters()}
    opt, sched = get_optimizer({"name": name, "lr": 0.1, "weight_decay": 0.3, "epsilon": 1e-6},
                               model.parameters(), lambda s: 0.1, weight_decay_fn=wd_fn,
                               grad_clip=clip, steps=4)
    taken = {}
    for n, p in model.named_parameters():
        if n != "unused":
            p.grad = torch.randn_like(p) * 0.1
            taken[f"model.{n}"] = p.grad.clone() if clip is None else p.grad.clamp(-clip, clip)
    opt.step()
    sched.step()
    trainer = types.SimpleNamespace(state=types.SimpleNamespace(
        model=model, optimizer=opt, scheduler=sched))
    return trainer, weights, taken


@pytest.mark.parametrize("optimizer", list(OPTIMIZERS))
def test_first_grad_is_the_gradient_the_optimizer_took(optimizer):
    trainer, weights, taken = _stepped(optimizer)
    got = program.first_grad(trainer, weights)
    assert set(got) == set(weights)
    for name, g in taken.items():
        torch.testing.assert_close(got[name], g, rtol=1e-6, atol=1e-6)
        assert got[name].abs().max() > 0
    if OPTIMIZERS[optimizer][2] is not None:
        assert any((g.abs() == CLIP).any() for g in taken.values())
    assert torch.equal(got["model.unused"], torch.zeros(3))


def test_first_grad_raises_on_an_optimizer_it_does_not_read():
    model = _Tiny()
    opt = torch.optim.RMSprop(model.parameters(), lr=0.1)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    trainer = types.SimpleNamespace(state=types.SimpleNamespace(
        model=model, optimizer=opt, scheduler=None))
    weights = {f"model.{n}": p.detach().clone() for n, p in model.named_parameters()}
    with pytest.raises(TypeError, match="RMSprop"):
        program.first_grad(trainer, weights)


@pytest.mark.parametrize("name", ["adam_scheduled_decay", "adamw_clip_scheduled_decay"])
def test_reference_adam_steps_as_the_ports(name):
    """Three steps from the same gradients, with the clamp and a scheduled
    decay, coupled and decoupled: the reference's parameters within float32
    rounding of the port's, and the gradients it took clamped."""
    trainer, weights, grads = _stepped(name)   # the port's first step took `grads`
    model, opt, sched = trainer.state.model, trainer.state.optimizer, trainer.state.scheduler
    params = {n: w.clone() for n, w in weights.items() if n in grads}
    moments, gen = {}, torch.Generator().manual_seed(5)
    for step in range(3):
        if step:
            grads = {n: torch.randn(params[n].shape, generator=gen) for n in params}
            for n, p in model.named_parameters():
                p.grad = grads[f"model.{n}"].clone() if f"model.{n}" in grads else None
            opt.step()
            sched.step()
        took = common.adam(params, grads, moments, step, 0.1, _wd(step),
                           decoupled=name.startswith("adamw"), clip=CLIP, eps=1e-6)
        assert max(float(g.abs().max()) for g in took.values()) == CLIP
    for n, p in model.named_parameters():
        if f"model.{n}" in params:
            torch.testing.assert_close(params[f"model.{n}"], p.detach(), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# the port's DINO on a tiny ViT
# --------------------------------------------------------------------------

def _dino_config(tmp_path) -> tuple[str, dict]:
    """`configs/dino.yaml` cut to a ViT the CPU steps in seconds (two
    layers, 16x16 global views of 16 patches, batch 16), float32."""
    cfg = yaml.safe_load((ROOT / "configs" / "dino.yaml").read_text())
    cfg.update(algo="dino", arch="vit", compute_dtype="float32")
    cfg["encoder"].update(num_encoder_layers=2, num_global_patches=16)
    cfg["data"]["batch_size"] = 16
    crop = cfg["data"]["multicrop_config"]
    crop["global_size"] = [16, 16]
    crop["test_transforms"]["center_crop"]["size"] = [16, 16]
    path = tmp_path / "dino_tiny.json"
    path.write_text(json.dumps(cfg))
    return str(path), cfg


def _kind(name: str, t: torch.Tensor) -> str:
    if name.endswith(".bias"):
        return "zero"
    if name.endswith(".weight"):
        return "one" if t.dim() == 1 else "linear"
    return "table"


def test_dino_takes_a_marked_center_and_reads_back_its_first_gradient(tmp_path):
    path, cfg = _dino_config(tmp_path)
    traffic = {"n_train": 64, "n_test": 16, "image": [32, 32, 3], "classes": 10}
    seed = 2**35 + 9
    data = inputs.images(traffic, seed, "cpu")
    trainer = program.build(path, cfg, data, inputs.streams(seed)["draws"], torch.device("cpu"))
    specs = [(n, tuple(p.shape), _kind(n, p)) for n, p in program._leaves(trainer).items()]
    specs.append(("center.value", (1, int(cfg["proj_head"]["proj_dim"])), "normal", "buffer"))
    weights = inputs.weights(specs, seed, "cpu")
    assert inputs.buffers(specs) == {"center.value"}

    with pytest.raises(KeyError, match="center.nope"):
        program.load_weights(trainer, {**weights, "center.nope": weights["center.value"]},
                             ["center.value", "center.nope"])
    program.load_weights(trainer, weights, ["center.value"])
    center = trainer.state.extra["center"].value
    assert torch.equal(center, weights["center.value"])

    program.begin_run(trainer)
    program.begin_epoch(trainer, 1)
    trainer.step(trainer.state)
    got = program.first_grad(trainer, weights)
    student = dict(trainer.state.model.named_parameters())
    assert set(got) == {f"model.{n}" for n in student}
    reached = 0
    for n, p in student.items():
        g = got[f"model.{n}"]
        assert torch.isfinite(g).all(), n
        if p.grad is None:
            assert not g.any(), n
            continue
        reached += 1
        assert g.abs().max() > 0, n
        # the clamp was applied to the gradient in place before the update
        torch.testing.assert_close(g, p.grad, rtol=1e-5, atol=1e-7)
    assert reached == len(student)
    assert not torch.equal(trainer.state.extra["center"].value, weights["center.value"])
