"""The benchmark's DINO ViT cell (`perfbench/reference/dino.py`,
`perfbench/reference/vit.py`) against the port, on the CPU at a tiny
size: the reference ViT and the port's `TransformerEncoder` from the same
weights in float32, forward and every leaf's gradient, at the global and
the local sequence length; the reference's multi-crop views and the
port's `MultiCrop.batch_call` from one generator seed; the harness driven
as on the card (`harness.measure`), the port in float32, a sound run
`correct` and each fault planted in the port not; and the reference
importing neither JAX, the JAX package nor the port."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness, inputs
from perfbench.reference import dino as ref_dino
from perfbench.reference import vit as ref_vit
from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[1]
CELL = "dino_vit_b64_multicrop"
# the tiny ViT: width 32, 2 heads, 2 layers, 16x16 globals (16 patches of 4)
# and 8x8 locals (4 patches)
ENCODER = {"hidden_dim": 32, "embedding_dim": 16, "intermediate_dim": 64,
           "num_attention_heads": 2, "patch_size": 4, "num_encoder_layers": 2,
           "num_global_patches": 16, "num_local_patches": 4}
VIT = {"encoder": ENCODER, "proj_head": {"hidden_dim": 32, "proj_dim": 64},
       "data": {"batch_size": 4, "multicrop_config": {"global_size": [16, 16]}}}
# 20 steps an epoch at batch 4 over tiny.TRAFFIC's 80 images; a run of 100
# epochs warming up over 39 (780 steps), so the first steps' learning rates
# are ten times the full cell's (1e-4 x step / 7,810), and the tables short
SCHEDULE = {"epochs": 100, "scheduler": {"warmup_epochs": 39}, "compute_dtype": "float32"}

torch.set_num_threads(2)


def _cfg() -> dict:
    cfg = json.loads((ROOT / "perfbench/configs/dino_vit_cifar10.json").read_text())
    return harness._merge(cfg, VIT)


def _port_encoder(weights: dict):
    from ssv_tpu_torch.models.vit import TransformerEncoder

    enc = TransformerEncoder(**ENCODER, dtype=torch.float32)
    enc.load_state_dict(weights)
    return enc


@pytest.mark.parametrize("size", [16, 8])
def test_reference_vit_matches_the_port(size):
    """Forward and the gradient of every leaf, float32, at 17 and 5 tokens."""
    weights = inputs.weights(ref_vit.specs("", ENCODER), 2**35 + 1, "cpu")
    port = _port_encoder(weights)
    g = torch.Generator().manual_seed(size)
    img = torch.randn(4, size, size, 3, generator=g)
    probe = torch.randn(4, ENCODER["hidden_dim"], generator=g)
    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
    want = ref_vit.forward(params, "", img, ENCODER, lambda x: x)
    got = port(img)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    want_grads = torch.autograd.grad((want * probe).sum(), list(params.values()),
                                     allow_unused=True)
    (got * probe).sum().backward()
    used = 0
    for (name, p), gw in zip(params.items(), want_grads):
        gp = dict(port.named_parameters())[name].grad
        if gw is None:      # the other length's position table
            assert gp is None or not gp.any(), name
            continue
        used += 1
        # float32 rounding of sums over tokens: relative to the leaf's largest
        torch.testing.assert_close(gp, gw, rtol=1e-4, atol=1e-5 * float(gw.abs().max()),
                                   msg=name)
    assert used == len(params) - 1


def test_reference_views_match_the_port():
    """Both base views, then each group of crops, from one generator seed:
    equal within float32 rounding, in the port's order of draws."""
    from ssv_tpu_torch.data.multicrop import MultiCrop

    cfg = _cfg()
    raw = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(3))
    port = MultiCrop(cfg["data"]["multicrop_config"]).batch_call(
        torch.Generator().manual_seed(2**34 + 5), raw)
    gen = torch.Generator().manual_seed(2**34 + 5)
    want = ref_dino.views(gen, raw, cfg)
    for key, w in zip(("global_1", "global_2", "local_1", "local_2"), want):
        assert port[key].shape == w.shape, key
        torch.testing.assert_close(port[key], w, rtol=1e-5, atol=2e-5, msg=key)
    # both sides took the same number of draws
    a = torch.rand(3, generator=gen)
    gen_p = torch.Generator().manual_seed(2**34 + 5)
    MultiCrop(cfg["data"]["multicrop_config"]).batch_call(gen_p, raw)
    assert torch.equal(a, torch.rand(3, generator=gen_p))


def _measure():
    import time

    over = harness._merge(SCHEDULE, VIT)
    cell = harness.Cell(CELL, overrides=over, traffic=tiny.TRAFFIC)
    return harness.measure(cell, 2**33 + 7, 0.0, False, "cpu", time.perf_counter(),
                           log=lambda msg: None, warn=lambda msg: None)


def test_sound_run_is_correct():
    res = _measure()
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


def _skipped(monkeypatch):
    """The optimizer's step does nothing."""
    from ssv_tpu_torch.train.optim import OptaxAdam

    monkeypatch.setattr(OptaxAdam, "step", lambda self, closure=None: None)


def _half(monkeypatch):
    """Half of each crop group's images left out."""
    from ssv_tpu_torch.train.algorithms.dino import DINO

    step = DINO.train_step

    def halved(self, state, batch, generator=None):
        n = batch["global_1"].shape[0] // 2
        return step(self, state, {k: v[:n] for k, v in batch.items()}, generator)

    monkeypatch.setattr(DINO, "train_step", halved)


def _doubled(monkeypatch):
    """The first parameter's gradient doubled as the optimizer takes it."""
    from ssv_tpu_torch.train.optim import OptaxAdam

    step = OptaxAdam.step

    def doubled(self, closure=None):
        self.param_groups[0]["params"][0].grad.mul_(2.0)
        return step(self, closure)

    monkeypatch.setattr(OptaxAdam, "step", doubled)


def _frozen_late(monkeypatch):
    """The state left unchanged from the fourth step on."""
    from ssv_tpu_torch.train.optim import OptaxAdam

    step, calls = OptaxAdam.step, []

    def late(self, closure=None):
        calls.append(1)
        return step(self, closure) if len(calls) <= 3 else None

    monkeypatch.setattr(OptaxAdam, "step", late)


@pytest.mark.parametrize("fault", [_skipped, _half, _doubled, _frozen_late])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _measure()
    assert res["correct"] is False, res["checks"]


def test_reference_imports_no_jax_and_no_port():
    code = ("import sys, perfbench.reference.dino, perfbench.counts.dino; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'jaxlib', 'flax', 'ssv_tpu', 'ssv_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
