"""The schedules of the shapes100 quality rows at their full horizon, on the
CPU and with no model step: for each shipped config at the row's epochs
(300 or 1,000) over 50,000 images at the row's batch, as
`tools/quality_run.py` builds it, the port's per-step tables equal the JAX
package's functions at every step of the run. The other schedule tests run
a few steps (`test_torch_epoch_program.py`, `test_torch_small.py`); these
isolate a fault of a long run's schedule from one of its training. DINO's
row (ResNet-18, `teacher_update: step`, `center_init: zeros`, 1,000 epochs
of 320 steps on 20,480 images at B = 64) holds its learning rate, weight
decay, teacher temperature and per-step teacher momentum the same way.

SwAV schedules nothing but its learning rate in either package (neither
freezes its prototypes; the one freeze, DINO's `freeze_last_layer`, is not
on these rows), so its case holds the learning rate and that the table has
no other column."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssv_tpu.train.base import DataInfo as JDataInfo
from ssv_tpu.train.registry import build_algorithm as jax_build_algorithm
from ssv_tpu.utils import schedules as JS
from ssv_tpu_torch.tools.quality_run import quality_config
from ssv_tpu_torch.train.base import DataInfo as TDataInfo
from ssv_tpu_torch.train.registry import build_algorithm

torch.set_num_threads(2)

N_TRAIN = 50000

# (algo, epochs, batch) of each row, as VALIDATION.md ran them
ROWS = [("relic", 300, 512), ("barlow", 300, 512), ("swav", 300, 512), ("sela", 300, 500),
        ("pirl", 300, 256), ("deep_cluster", 300, 512), ("simclr", 1000, 512),
        ("moco", 1000, 256), ("byol", 1000, 512), ("simsiam", 1000, 512)]


def _build(algo, epochs, batch, n_train=N_TRAIN, overrides=None):
    """(config, the JAX algorithm, the port's algorithm and its schedule)."""
    cfg = quality_config(algo, epochs, "shapes100", 50 if epochs == 300 else 100, None,
                         overrides or {})
    assert cfg["data"]["batch_size"] == batch
    spe = n_train // batch
    jalgo = jax_build_algorithm(algo, cfg, "resnet18", JDataInfo(100, n_train, batch, spe))
    talgo = build_algorithm(algo, cfg, "resnet18", TDataInfo(100, n_train, batch, spe), "cpu")
    state = talgo.init_state(torch.Generator().manual_seed(0))
    return cfg, jalgo, talgo, state.scheduler, state.optimizer


def _column(sched, name):
    return sched.table[:, sched.columns[name]].numpy()


@pytest.mark.parametrize("algo,epochs,batch", ROWS, ids=[r[0] for r in ROWS])
def test_lr_and_weight_decay_over_the_whole_run(algo, epochs, batch):
    """The learning-rate table has a row for every step of the run and one,
    each within 2^-22 of the base learning rate (about two float32 units in
    its last place) of the JAX schedule at that step: numpy's and XLA's
    float32 warmup and cosine differ in their last bits, and the base rate
    scales the difference. The weight
    decay is the config's at every step in both: no decay column in the
    table, and one update of each optimizer on a parameter of 1 with a zero
    gradient at lr 1 moves it by the same 1.9 · wd (Nesterov, momentum 0.9)."""
    cfg, jalgo, talgo, sched, opt = _build(algo, epochs, batch)
    n = epochs * (N_TRAIN // batch) + 1
    assert sched.table.shape[0] == n and talgo.total_steps == jalgo.total_steps == n - 1
    got = _column(sched, "lr")
    want = np.asarray(jax.jit(jax.vmap(jalgo.lr_fn()))(jnp.arange(n)), np.float64)
    assert np.abs(got - want).max() <= 2.0 ** -22 * float(cfg["optimizer"]["lr"])

    assert "weight_decay" not in sched.columns
    wd = float(cfg["optimizer"]["weight_decay"])
    assert [g["weight_decay"] for g in opt.param_groups] == [wd] * len(opt.param_groups)
    jtx = jalgo.make_tx(lr_fn=lambda s: 1.0)
    p = jnp.ones((1,), jnp.float32)
    jupd, _ = jtx.update(jnp.zeros_like(p), jtx.init(p), p)
    tp = torch.nn.Parameter(torch.ones(1))
    topt = torch.optim.SGD([tp], lr=1.0, momentum=0.9, nesterov=True,
                           weight_decay=opt.param_groups[0]["weight_decay"])
    tp.grad = torch.zeros(1)
    topt.step()
    np.testing.assert_allclose((tp.detach() - 1.0).numpy(), np.asarray(optax.apply_updates(
        p, jupd)) - 1.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jupd), [-1.9 * wd], rtol=1e-6)


@pytest.mark.parametrize("algo", ["byol", "relic"])
def test_tau_over_the_whole_run(algo):
    """BYOL's and ReLIC's EMA rate at every step of their row's run (BYOL
    1,000 epochs of 97 steps, ReLIC 300), tabled on the device, against the
    JAX package's `cosine_ramp` over the global step: within 1e-7 at every
    step, 0.996 at step 0 and 1.0 at the end."""
    epochs = 1000 if algo == "byol" else 300
    _, jalgo, talgo, sched, _ = _build(algo, epochs, 512)
    n = sched.table.shape[0]
    got = _column(sched, "tau")
    ramp = jax.jit(jax.vmap(lambda s: JS.cosine_ramp(s, jalgo.total_steps, jalgo.tau_lower,
                                                     jalgo.tau_upper)))
    want = np.asarray(ramp(jnp.arange(n)), np.float64)
    if algo == "byol":
        np.testing.assert_array_equal(
            want, np.asarray(jax.jit(jax.vmap(jalgo._tau))(jnp.arange(n)), np.float64))
    np.testing.assert_array_less(np.abs(got - want), 1e-7)
    assert got[0] == pytest.approx(0.996, abs=1e-7) and got[-1] == 1.0


@pytest.mark.parametrize("epochs", [300, 500])
def test_sela_relabel_epochs_at_the_row_horizon(epochs):
    """SeLA's self-labelling epochs at the row's 300 epochs (and the shipped
    config's own 500) are JAX's set, {int(E · (i / (n − 1))²)} for i in
    1..n − 2, quadratically spaced; and the sets differ between the two
    horizons, so a row run at the config's epochs would relabel elsewhere."""
    cfg, jalgo, talgo, _, _ = _build("sela", epochs, 500)
    n = int(cfg["self_label_iters"])
    want = {int(epochs * (i / (n - 1)) ** 2) for i in range(1, n - 1)}
    assert talgo.sl_epochs == jalgo.sl_epochs == want
    assert len(want) >= 2 and max(want) < epochs


def test_swav_schedules_only_its_learning_rate():
    """SwAV's port tables the learning rate alone, and the JAX package's
    SwAV has no freeze or other step-dependent setting."""
    _, jalgo, _, sched, _ = _build("swav", 300, 512)
    assert list(sched.columns) == ["lr"]
    assert not [k for k in vars(jalgo) if "freeze" in k or "tau" in k]


def test_dino_resnet18_schedules_over_the_whole_run():
    """DINO's ResNet-18 row: 1,000 epochs of 320 steps (20,480 images, B =
    64), AdamW. At every one of the 320,001 steps the port's table holds the
    learning rate within 2^-22 of the base rate of JAX's `lr_fn`, and within
    1e-7 of the JAX package's functions: the weight decay (its cosine ramp
    0.04 -> 0.4 over the epochs, as JAX's `wd_fn` takes it at step // 320),
    the teacher temperature (0.04 -> 0.07 over 30 epochs, at step // 320)
    and the per-step teacher momentum (`cosine_ramp` over the total steps,
    as the step-EMA reads it at `state.step`), with their end values."""
    spe, epochs = 20480 // 64, 1000
    cfg, jalgo, talgo, sched, opt = _build(
        "dino", epochs, 64, n_train=20480,
        overrides={"teacher_update": "step", "center_init": "zeros"})
    assert talgo.teacher_update == jalgo.teacher_update == "step"
    assert talgo.center_init == jalgo.center_init == "zeros"
    assert cfg["optimizer"]["name"] == "adamw"
    n = epochs * spe + 1
    assert sched.table.shape[0] == n and talgo.total_steps == jalgo.total_steps == n - 1
    steps = jnp.arange(n)
    epoch = steps // spe

    got = _column(sched, "lr")
    want = np.asarray(jax.jit(jax.vmap(jalgo.lr_fn()))(steps), np.float64)
    assert np.abs(got - want).max() <= 2.0 ** -22 * float(cfg["optimizer"]["lr"])

    wd = np.asarray(jax.jit(jax.vmap(lambda e: JS.cosine_ramp(
        e, jalgo.epochs, jalgo.wd_lower, jalgo.wd_upper)))(epoch), np.float64)
    temp = np.asarray(jax.jit(jax.vmap(lambda e: JS.dino_teacher_temp(
        e, lower=jalgo.temp_t_lower, upper=jalgo.temp_t_upper,
        warmup_epochs=jalgo.temp_warmup_epochs)))(epoch), np.float64)
    lbd = np.asarray(jax.jit(jax.vmap(lambda s: JS.cosine_ramp(
        s, jalgo.total_steps, jalgo.lambda_lower, jalgo.lambda_upper)))(steps), np.float64)
    for name, want in (("weight_decay", wd), ("teacher_temp", temp), ("lambda", lbd)):
        np.testing.assert_array_less(np.abs(_column(sched, name) - want), 1e-7, err_msg=name)
    assert _column(sched, "weight_decay")[0] == pytest.approx(0.04, abs=1e-7)
    assert _column(sched, "weight_decay")[-1] == pytest.approx(0.4, abs=1e-7)
    assert _column(sched, "teacher_temp")[-1] == pytest.approx(0.07, abs=1e-7)
    assert _column(sched, "lambda")[0] == pytest.approx(0.996, abs=1e-7)
    assert _column(sched, "lambda")[-1] == 1.0
    # in float32 the momentum rounds to 1.0 (a frozen teacher) about two
    # epochs before the end in both packages, within a step of each other
    # (the cosine's last bit)
    frozen_at = np.argmax(_column(sched, "lambda") == 1.0), np.argmax(lbd == 1.0)
    assert abs(frozen_at[0] - frozen_at[1]) <= 1 and max(frozen_at) < n - spe
