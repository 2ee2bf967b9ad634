"""The epoch as one device program (the JAX package's default `jit_epoch`),
on the CPU: the per-step numbers as device tables equal the host schedules
bit for bit; the device-counter SGD equals torch's fused SGD bit for bit;
the device-count Adam chain and DINO's step equal the JAX package's through
six steps that cross the warmup, `freeze_last_layer` and teacher
temperature boundaries; no step of any algorithm reads the host; the mode
rule; a capture that raises stops training; and a checkpoint of the
host-count format resumes to the same state. The CUDA graph itself runs on
the card (chip_smoke.py, phase `graph`)."""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import helpers
from ssv_tpu.train.base import DataInfo as JDataInfo
from ssv_tpu.train.registry import build_algorithm as jax_build_algorithm
from ssv_tpu.utils import schedules as JS
from ssv_tpu_torch.train import graph as graph_mod
from ssv_tpu_torch.train import trainer as trainer_mod
from ssv_tpu_torch.train.base import DataInfo as TDataInfo
from ssv_tpu_torch.train.optim import OptaxAdam, StepSchedule, get_optimizer
from ssv_tpu_torch.train.registry import build_algorithm
from ssv_tpu_torch.train.trainer import Trainer
from ssv_tpu_torch.utils import schedules as TS
from torch_helpers import assert_state_matches, load_jax_state, t

torch.set_num_threads(2)

EPOCHS, SPE = 2, 3          # six steps: the warmup, freeze and temperature
                            # boundaries fall between steps 3 and 4


# --------------------------------------------------------------------------
# the schedule tables
# --------------------------------------------------------------------------

SCHEDULERS = [{"name": "cosine", "warmup_epochs": 1}, {"name": "cosine", "warmup_epochs": 0},
              {"name": "multistep", "milestones": [1, 2], "gamma": 0.1}, {"name": "none"}]


@pytest.mark.parametrize("scheduler", SCHEDULERS, ids=["warmup-cosine", "cosine",
                                                       "multistep", "constant"])
def test_lr_table_equals_the_host_schedule(scheduler):
    """Every row of the learning-rate table is `lr_schedule`'s float32 value
    of its step, bit for bit, and the JAX package's within 1e-7 of max(1,
    lr), as `test_lr_schedule_every_step` holds the host function (its
    cosine is XLA's, the table's numpy's)."""
    opt_cfg = {"name": "sgd", "lr": 0.3, "weight_decay": 1e-4}
    lr_fn = TS.lr_schedule(opt_cfg, scheduler, epochs=3, steps_per_epoch=7)
    jfn = JS.lr_schedule(opt_cfg, scheduler, epochs=3, steps_per_epoch=7)
    p = torch.nn.Parameter(torch.zeros(3))
    _, sched = get_optimizer(opt_cfg, [p], lr_fn, steps=22)
    table = sched.table[:, sched.columns["lr"]]
    assert table.dtype == torch.float32 and table.shape == (22,)
    assert table.tolist() == [lr_fn(s) for s in range(22)]
    for s in range(22):
        want = float(jfn(s))
        assert abs(table[s].item() - want) <= 1e-7 * max(1.0, want), s


@pytest.mark.parametrize("algo", ["byol", "relic", "dino"])
def test_algorithm_tables_equal_the_host_functions(algo):
    """BYOL's and ReLIC's tau, DINO's teacher temperature, frozen flag,
    step-wise lambda and decay ramp, and Adam's bias corrections, tabled
    over the run's steps and one, equal their host functions bit for bit."""
    cfg = helpers.mini_config(algo, epochs=EPOCHS)
    cfg.update(freeze_last_layer=1, temp_warmup_epochs=1)
    arch = "vit" if algo == "dino" else "tiny"
    talgo = build_algorithm(algo, cfg, arch, TDataInfo(10, 4 * SPE, 4, SPE), "cpu")
    state = talgo.init_state(torch.Generator().manual_seed(0))
    sched = state.scheduler
    n = EPOCHS * SPE + 1
    assert sched.table.shape[0] == n
    col = lambda name: sched.table[:, sched.columns[name]].tolist()  # noqa: E731
    if algo == "dino":
        assert col("teacher_temp") == [talgo.teacher_temp(s // SPE) for s in range(n)]
        assert col("frozen") == [float(s < SPE) for s in range(n)]
        assert col("lambda") == [TS.cosine_ramp(s, EPOCHS * SPE, 0.99, 1.0) for s in range(n)]
        assert col("weight_decay") == [talgo.weight_decay(s) for s in range(n)]
        assert col("adam_c1") == [float(np.float32(1) - np.float32(0.9) ** np.float32(s + 1))
                                  for s in range(n)]
        assert col("adam_c2") == [float(np.float32(1) - np.float32(0.999) ** np.float32(s + 1))
                                  for s in range(n)]
    else:
        assert col("tau") == [talgo.tau(s) for s in range(n)]


def test_table_grows_past_the_run():
    """Eager steps past the steps a schedule was sized for refill its table
    twice as long, with the host function's values."""
    lr_fn = TS.lr_schedule({"lr": 0.1}, {"name": "cosine", "warmup_epochs": 1}, epochs=2,
                           steps_per_epoch=2)
    p = torch.nn.Parameter(torch.ones(2))
    opt, sched = get_optimizer({"name": "sgd", "lr": 0.1}, [p], lr_fn, steps=2)
    for s in range(5):
        p.grad = torch.ones(2)
        opt.step()
        assert opt.param_groups[0]["lr"].item() == lr_fn(s)
        sched.step()
    n = sched.table.shape[0]
    assert n >= 5 and int(sched.counter) == sched.taken == 5
    assert sched.table[:, sched.columns["lr"]].tolist() == [lr_fn(s) for s in range(n)]


# --------------------------------------------------------------------------
# the optimizers
# --------------------------------------------------------------------------

def _sgd_runs(steps=8, wd=1e-4):
    """The port's SGD (device lr from the table, counter) and torch's fused
    and default SGD at lr(step) set on the host by LambdaLR, from the same
    parameters and gradients. Returns the three parameter lists and the
    port's and the fused one's momentum buffers."""
    rs = np.random.RandomState(3)
    shapes = [(7, 5), (5,), (2, 3, 3)]
    init = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) for s in shapes] for _ in range(steps)]
    lr_fn = TS.lr_schedule({"lr": 0.4}, {"name": "cosine", "warmup_epochs": 1},
                           epochs=2, steps_per_epoch=steps // 2)
    cfg = {"name": "sgd", "lr": 0.4, "weight_decay": wd}

    def params():
        return [torch.nn.Parameter(t(a)) for a in init]

    ours, theirs, default = params(), params(), params()
    opt, sched = get_optimizer(cfg, ours, lr_fn, steps=steps + 1)
    ref = torch.optim.SGD(theirs, lr=1.0, momentum=0.9, nesterov=True, weight_decay=wd,
                          fused=True)
    ref_sched = torch.optim.lr_scheduler.LambdaLR(ref, lr_fn)
    plain = torch.optim.SGD(default, lr=1.0, momentum=0.9, nesterov=True, weight_decay=wd)
    plain_sched = torch.optim.lr_scheduler.LambdaLR(plain, lr_fn)
    for g in grads:
        for ps in (ours, theirs, default):
            for p, gi in zip(ps, g):
                p.grad = t(gi)
        for o, s in ((opt, sched), (ref, ref_sched), (plain, plain_sched)):
            o.step()
            s.step()
    bufs = [[o.state[p]["momentum_buffer"] for p in ps]
            for o, ps in ((opt, ours), (ref, theirs))]
    return ours, theirs, default, bufs


def test_device_counter_sgd_equals_torch_sgd():
    """The port's SGD is torch.optim.SGD (momentum 0.9, Nesterov, coupled
    decay) in its fused form with the lr a device tensor read from the
    table: over eight steps across the warmup its parameters and momentum
    buffers equal torch's fused SGD stepped at lr(step) from the host, bit
    for bit. Torch's default (for-loop) SGD rounds in float32 where the
    fused kernel keeps its sums in float64: the two stay within 1e-6."""
    ours, theirs, default, (buf_ours, buf_theirs) = _sgd_runs()
    for a, b, c in zip(ours, theirs, default):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(), rtol=0, atol=1e-6)
    for a, b in zip(buf_ours, buf_theirs):
        assert torch.equal(a, b)


def test_scheduled_sgd_decay_is_added_on_the_device():
    """With a decay schedule the fused SGD takes no decay of its own: the
    pre-hook adds wd(step) p to each gradient, wd read at the counter."""
    p = torch.nn.Parameter(torch.full((4,), 2.0))
    opt, sched = get_optimizer({"name": "sgd", "lr": 0.5}, [p], lambda s: 0.5,
                               weight_decay_fn=lambda s: 0.25 * (s + 1), steps=4)
    assert opt.param_groups[0]["weight_decay"] == 0.0
    p.grad = torch.zeros(4)
    opt.step()
    # g = 0 + 0.25 * 2; buf = g; p -= 0.5 * (g + 0.9 g)
    assert torch.equal(p.detach(), torch.full((4,), 2.0 - 0.5 * (0.5 + 0.9 * 0.5)))


def _dino_config(**extra):
    cfg = helpers.mini_config("dino", epochs=EPOCHS)
    cfg["compute_dtype"] = "float32"
    cfg["optimizer"]["lr"] = 1e-3
    cfg["scheduler"] = {"name": "cosine", "warmup_epochs": 1}
    cfg["data"]["multicrop_config"]["global_size"] = [16, 16]
    cfg["encoder"].update(num_global_patches=16, num_attention_heads=2)
    cfg.update(freeze_last_layer=1, temp_warmup_epochs=1, **extra)
    return cfg


def _dino_batch(step, b=4):
    rs = np.random.RandomState(20 + step)
    return {"global_1": rs.rand(b, 2, 16, 16, 3).astype(np.float32),
            "global_2": rs.rand(b, 2, 16, 16, 3).astype(np.float32),
            "local_1": rs.rand(b, 2, 8, 8, 3).astype(np.float32),
            "local_2": rs.rand(b, 2, 8, 8, 3).astype(np.float32)}


@pytest.mark.parametrize("extra", [{}, {"teacher_update": "step"}],
                         ids=["teacher-epoch", "teacher-step"])
def test_dino_six_steps_across_the_boundaries(extra):
    """DINO's ViT step (adamw with the clamp and the decay ramp, the device
    counter, its tables) against the JAX package's `train_step` applied six
    times to the same batches, 3 steps an epoch: the lr leaves its warmup,
    `fc_out` unfreezes and the teacher temperature and decay change between
    steps 3 and 4. Losses within 1e-5 relative at every step; after the six
    steps and the epoch's EMA the state within 1e-5; `fc_out` unchanged
    through step 3; the counter, the groups' `count` and Adam's `step` at 6."""
    cfg = _dino_config(**extra)
    info = (10, 4 * SPE, 4, SPE)
    jalgo = jax_build_algorithm("dino", cfg, "vit", JDataInfo(*info))
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    talgo = build_algorithm("dino", cfg, "vit", TDataInfo(*info), "cpu")
    tstate = talgo.init_state(torch.Generator().manual_seed(0))
    load_jax_state(tstate, jstate, "dino")
    assert isinstance(tstate.optimizer, OptaxAdam)
    fc_out = [p.detach().clone() for p in tstate.model.proj.fc_out.parameters()]
    jstep = jax.jit(jalgo.train_step)
    for s in range(EPOCHS * SPE):
        batch = _dino_batch(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        tstate, tm = talgo.train_step(tstate, {k: t(v) for k, v in batch.items()})
        want, got = float(jm["loss"]), tm["loss"].item()
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (s, got, want)
        unchanged = all(torch.equal(a, b) for a, b in
                        zip(fc_out, tstate.model.proj.fc_out.parameters()))
        assert unchanged == (s < SPE), s
    jstate = jalgo.post_epoch(jstate, EPOCHS)
    tstate = talgo.post_epoch(tstate, EPOCHS)
    assert tstate.step == int(jstate.step) == int(tstate.counter) == 6
    assert [int(g["count"]) for g in tstate.optimizer.param_groups] == [6]
    assert all(int(st["step"]) == 6 for st in tstate.optimizer.state.values())
    assert_state_matches(tstate, jstate, "dino", param_tol=1e-5)


# --------------------------------------------------------------------------
# the step reads nothing on the host
# --------------------------------------------------------------------------

HOST_READS = ("item", "__bool__", "__float__", "__int__", "__index__", "tolist", "cpu",
              "numpy")


@contextlib.contextmanager
def no_host_reads():
    """Inside, every Tensor method that reads a value to the host raises, and
    so does every copy from the host, which a capture refuses on the card:
    a tensor made from host data (`torch.tensor`, `as_tensor` of what is not
    a tensor, `from_numpy`) and a host number written through an index
    (`t[i] = x`)."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}
    made = {name: getattr(torch, name) for name in ("tensor", "as_tensor", "from_numpy")}

    def refuse(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"the step read a tensor on the host: Tensor.{name}")
        return read

    def refuse_host_data(name):
        def make(data, *args, **kwargs):
            if name == "as_tensor" and torch.is_tensor(data):
                return made[name](data, *args, **kwargs)
            raise AssertionError(f"the step made a tensor from host data: torch.{name}")
        return make

    setitem = torch.Tensor.__setitem__

    def write(self, key, value):
        if not torch.is_tensor(value):
            raise AssertionError(f"the step wrote a host number into a tensor: {value!r}")
        return setitem(self, key, value)

    try:
        for name in HOST_READS:
            setattr(torch.Tensor, name, refuse(name))
        for name in made:
            setattr(torch, name, refuse_host_data(name))
        torch.Tensor.__setitem__ = write
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
        for name, fn in made.items():
            setattr(torch, name, fn)
        torch.Tensor.__setitem__ = setitem


def _cpu_trainer(tmp_path, algo, arch="tiny", epochs=1, cfg_extra=None, **args):
    cfg = helpers.mini_config(algo, epochs=epochs)
    cfg.update(cfg_extra or {})
    path = tmp_path / f"{algo}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return Trainer({"config": str(path), "algo": algo, "arch": arch, "task": "train",
                    "output": "run", "load": None, **args},
                   synthetic_sizes=(64, 32), device="cpu")


GUARDED = [("simclr", "tiny", {}), ("byol", "tiny", {}), ("dino", "vit", {}),
           ("dino", "vit", {"teacher_update": "step", "freeze_last_layer": 1}),
           ("moco", "tiny", {}), ("swav", "tiny", {}), ("simsiam", "tiny", {}),
           ("simsiam", "tiny", {"target_mode": "frozen"}), ("relic", "tiny", {}),
           ("barlow", "tiny", {}), ("sela", "tiny", {}), ("deep_cluster", "tiny", {}),
           ("pirl", "tiny", {})]


@pytest.mark.parametrize("algo,arch,extra", GUARDED,
                         ids=["simclr", "byol", "dino", "dino-step-freeze", "moco", "swav",
                              "simsiam", "simsiam-frozen", "relic", "barlow", "sela",
                              "deep_cluster", "pirl"])
def test_train_step_reads_nothing_on_the_host(algo, arch, extra, tmp_path, monkeypatch):
    """The step the graph captures (`Trainer._train_step`: the index row,
    the batch and its augmentations, the algorithm's `train_step`, the
    metric writes), after one eager step as the graph's warm-up takes,
    under a guard that makes `item`, `__bool__`, `__float__`, `__int__`,
    `__index__`, `tolist`, `cpu` and `numpy` raise, and any copy from the
    host (a tensor made from host data, a host number written through an
    index), for every algorithm, two steps; the metrics land at their
    positions."""
    monkeypatch.chdir(tmp_path)
    trainer = _cpu_trainer(tmp_path, algo, arch, cfg_extra=extra)
    state = trainer.algorithm.pre_train(trainer.state, trainer)
    trainer.begin_epoch(trainer.epoch_indices())
    trainer._train_step(state)
    with no_host_reads():
        trainer._train_step(state)
        trainer._train_step(state)
    assert state.step == 3 and int(trainer._pos) == 3 and int(state.counter) == 3
    assert torch.isfinite(trainer._metric_bufs["loss"][:3]).all()


# --------------------------------------------------------------------------
# the mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("device,jit_epoch,world,want", [
    ("cuda", None, 1, "graph"), ("cuda", True, 1, "graph"), ("cuda", False, 1, "step"),
    ("cuda", None, 2, "step"), ("cpu", None, 1, "step"), ("cpu", True, 1, "step")])
def test_epoch_mode_rule(device, jit_epoch, world, want, monkeypatch):
    """Graph where `jit_epoch` is unset or true on CUDA in one process; step
    where it is false, on the CPU, and across ranks."""
    monkeypatch.setattr(trainer_mod, "world_size", lambda: world)
    config = {} if jit_epoch is None else {"jit_epoch": jit_epoch}
    stub = types.SimpleNamespace(config=config, device=torch.device(device))
    mode, why = Trainer._epoch_mode(stub)
    assert mode == want and why


def test_cpu_run_logs_step_mode(tmp_path, monkeypatch):
    """A CPU run trains in step mode, says so in its epoch line and record,
    and `jit_epoch: false` gives the same losses."""
    monkeypatch.chdir(tmp_path)
    default = _cpu_trainer(tmp_path, "simclr", output="a")
    default.train()
    stepwise = _cpu_trainer(tmp_path, "simclr", cfg_extra={"jit_epoch": False}, output="b")
    stepwise.train()
    assert default.epoch_mode == stepwise.epoch_mode == "step"
    assert default.epoch_mode_reason == "cpu: no CUDA graphs"
    assert stepwise.epoch_mode_reason == "jit_epoch: false"
    assert default.epoch_stats[0]["mode"] == "step"
    assert default.epoch_stats[0]["losses"] == stepwise.epoch_stats[0]["losses"]
    log = (tmp_path / default.output_dir / "trainlogs.txt").read_text()
    assert "[mode] step" in log


def test_failed_capture_stops_training(tmp_path, monkeypatch):
    """Where the mode is graph, a capture that raises makes `train` raise
    with its error, and no step runs eagerly in its place."""
    monkeypatch.chdir(tmp_path)
    trainer = _cpu_trainer(tmp_path, "simclr")
    trainer.epoch_mode = "graph"

    def capture(self, trainer, state):
        raise RuntimeError("CUDA error: operation not permitted when stream is capturing")

    monkeypatch.setattr(graph_mod, "WARMUP_STEPS", 0)
    monkeypatch.setattr(graph_mod.StepGraph, "_capture", capture)
    with pytest.raises(RuntimeError, match="stream is capturing"):
        trainer.train()
    assert trainer.state.step == 0 and int(trainer.state.counter) == 0
    assert trainer.epoch_stats == []


def test_checkpoint_load_drops_the_graph(tmp_path, monkeypatch):
    """A checkpoint load replaces the optimizer's state tensors: the trainer
    drops its graph, to capture anew."""
    monkeypatch.chdir(tmp_path)
    trainer = _cpu_trainer(tmp_path, "simclr")
    trainer.save_checkpoint("latest", epoch=1)
    trainer.graph = graph_mod.StepGraph()
    trainer.load_checkpoint(trainer.output_dir, "latest")
    assert trainer.graph is None


def test_steps_past_the_run_refill_the_tables_and_drop_the_graph(tmp_path, monkeypatch):
    """After `train` (4 steps, tables of 5 rows), more steps (a profile of
    the trained run) refill the tables with the host functions' values, and
    the trainer drops its graph, whose step read the old tables."""
    monkeypatch.chdir(tmp_path)
    trainer = _cpu_trainer(tmp_path, "byol")
    trainer.train()
    state, sched = trainer.state, trainer.state.scheduler
    assert state.step == 4 and sched.table.shape[0] == 5
    trainer.begin_epoch(trainer.epoch_indices())
    trainer.step(state)
    trainer.graph = graph_mod.StepGraph()
    trainer.step(state)
    assert trainer.graph is None and state.step == int(state.counter) == 6
    assert sched.table.shape[0] == 10
    assert sched.table[:, sched.columns["tau"]].tolist() == [
        trainer.algorithm.tau(s) for s in range(10)]
    assert torch.isfinite(trainer._metric_bufs["loss"][:2]).all()


# --------------------------------------------------------------------------
# checkpoints of the host-count format
# --------------------------------------------------------------------------

def _as_host_count_checkpoint(path, name):
    """Rewrites a checkpoint as the port wrote it with LambdaLR and host
    counts: the scheduler's LambdaLR state, the groups' lr (and the chain's
    count) as host numbers, torch's foreach SGD group, Adam's step an int."""
    blob = torch.load(path, weights_only=True)
    step = blob["step"]
    lr = float(blob["optimizer"]["param_groups"][0]["lr"])
    blob["scheduler"] = {"base_lrs": [1.0], "last_epoch": step, "_step_count": step + 1,
                         "_get_lr_called_within_step": False, "_last_lr": [lr],
                         "lr_lambdas": [None]}
    for group in blob["optimizer"]["param_groups"]:
        group["lr"], group["initial_lr"] = lr, 1.0
        group.pop("bias_correction", None)
        group.pop("count")
        if name == "sgd":
            group["fused"], group["foreach"] = None, None
        else:
            group["weight_decay"] = float(group["weight_decay"])
    for st in blob["optimizer"]["state"].values():
        if "step" in st:
            st["step"] = step
    torch.save(blob, path)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_host_count_checkpoint_resumes_exactly(name, tmp_path, monkeypatch):
    """A checkpoint of the format before the device counter (LambdaLR, host
    counts) loads into the same state: the resumed second epoch equals the
    straight run's, losses and weights bit for bit."""
    monkeypatch.chdir(tmp_path)
    extra = {} if name == "sgd" else {"optimizer": {"name": "adamw", "lr": 1e-3,
                                                    "epsilon": 1e-6, "weight_decay": 0.04}}
    straight = _cpu_trainer(tmp_path, "simclr", epochs=2, cfg_extra=extra, output="straight")
    straight.train()
    cut = _cpu_trainer(tmp_path, "simclr", epochs=2, cfg_extra=extra, output="cut")

    def stop_at_epoch_2(state, trainer, epoch):
        if epoch == 2:
            raise KeyboardInterrupt
        return state

    cut.algorithm.pre_epoch = stop_at_epoch_2
    with pytest.raises(KeyboardInterrupt):
        cut.train_safe()
    _as_host_count_checkpoint(tmp_path / cut.output_dir / "latest", name)
    resumed = _cpu_trainer(tmp_path, "simclr", epochs=2, cfg_extra=extra, output="resumed",
                           load=cut.output_dir)
    assert isinstance(resumed.state.scheduler, StepSchedule)
    assert int(resumed.state.counter) == resumed.state.step == cut.state.step
    resumed.train()
    assert resumed.epoch_stats[0]["losses"] == straight.epoch_stats[1]["losses"]
    for (k, a), b in zip(straight.state.model.state_dict().items(),
                         resumed.state.model.state_dict().values()):
        assert torch.equal(a, b), k
