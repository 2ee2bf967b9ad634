"""The port's `Trainer` constructor against the JAX Trainer's (`overrides`,
`allow_synthetic`, `make_dirs`, `seed`), and its `SSV_TPU_PROFILE_DIR`
trace hook, on the CPU at a tiny size."""

import json
import os

import pytest
import torch
import yaml

import helpers
from ssv_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)


def _args(tmp_path, algo="simclr", epochs=2, batch_size=16, **cfg_extra):
    """Trainer args for `mini_config(algo)` on `tiny` (the synthetic set,
    since the config's root holds no data), the config in tmp_path."""
    cfg = helpers.mini_config(algo, epochs=epochs, batch_size=batch_size)
    cfg.update(cfg_extra)
    path = tmp_path / f"{algo}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return {"config": str(path), "algo": algo, "arch": "tiny", "task": "train",
            "output": "run", "load": None}


def _first_batch(trainer):
    """The first train batch of the trainer's first epoch, drawn as
    `train()` draws it."""
    images, labels = trainer.pipeline.arrays("train")
    idx = trainer.epoch_indices()
    return trainer._batch_fn(images, labels, idx[0], trainer.generator)


def test_seed_420_draws_todays_first_batch(tmp_path, monkeypatch):
    """`seed=420` (the default) draws what the Trainer drew before it took a
    seed: weights from a host generator of 420, the epoch's indices and the
    first batch's augmentations from a device generator of 420 (rank 0)."""
    monkeypatch.chdir(tmp_path)
    args = _args(tmp_path)
    sizes = (64, 32)
    got = Trainer(args, synthetic_sizes=sizes, seed=420, device="cpu")
    default = Trainer(args, synthetic_sizes=sizes, device="cpu")
    batch, batch_default = _first_batch(got), _first_batch(default)

    # today's draws, by hand
    want_state = got.algorithm.init_state(torch.Generator().manual_seed(420))
    g = torch.Generator().manual_seed(420)
    images, labels = got.pipeline.arrays("train")
    want = got._batch_fn(images, labels, got.pipeline.epoch_indices(g)[0], g)

    assert batch.keys() == want.keys() == batch_default.keys()
    for k in want:
        assert torch.equal(batch[k], want[k]), k
        assert torch.equal(batch_default[k], want[k]), k
    for (name, p), q in zip(got.state.model.state_dict().items(),
                            want_state.model.state_dict().values()):
        assert torch.equal(p, q), name


def test_seed_421_draws_another_first_batch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = _args(tmp_path)
    a = Trainer(args, synthetic_sizes=(64, 32), seed=420, device="cpu")
    b = Trainer(args, synthetic_sizes=(64, 32), seed=421, device="cpu")
    ba, bb = _first_batch(a), _first_batch(b)
    assert not torch.equal(ba["aug_1"], bb["aug_1"])
    assert not torch.equal(ba["index"], bb["index"])
    wa = next(iter(a.state.model.parameters()))
    wb = next(iter(b.state.model.parameters()))
    assert not torch.equal(wa, wb)


OVERRIDES = {"epochs": 3, "optimizer": {"lr": 0.05, "momentum": 0.8},
             "data": {"batch_size": 8, "transforms": {"test": {"center_crop": {"size": [16, 16]}}}},
             "new_key": {"nested": [1, 2]}}


def test_overrides_merge_as_jax(tmp_path, monkeypatch):
    """The merged config equals the JAX Trainer's for the same `overrides`
    (nested dicts merge key by key; other values replace)."""
    from ssv_tpu.core.config import _merge as jax_merge
    from ssv_tpu.train import Trainer as JaxTrainer

    monkeypatch.chdir(tmp_path)
    args = _args(tmp_path)
    port = Trainer(args, overrides=OVERRIDES, synthetic_sizes=(64, 32), make_dirs=False,
                   device="cpu")
    jax_tr = JaxTrainer(args, overrides=OVERRIDES, synthetic_sizes=(64, 32), make_dirs=False)
    with open(args["config"]) as f:
        loaded = yaml.safe_load(f)
    assert port.config == jax_tr.config == jax_merge(loaded, OVERRIDES)
    assert port.config["data"]["transforms"]["train"] == loaded["data"]["transforms"]["train"]
    assert port.epochs == 3 and port.pipeline.batch_size == 8


def test_allow_synthetic_false_raises_as_jax(tmp_path, monkeypatch):
    """Where the config's dataset is not on disk, `allow_synthetic=False`
    raises the JAX Trainer's FileNotFoundError; the default falls back to
    the synthetic set."""
    from ssv_tpu.train import Trainer as JaxTrainer

    monkeypatch.chdir(tmp_path)
    args = _args(tmp_path)
    with pytest.raises(FileNotFoundError) as port_err:
        Trainer(args, allow_synthetic=False, make_dirs=False, device="cpu")
    with pytest.raises(FileNotFoundError) as jax_err:
        JaxTrainer(args, allow_synthetic=False, make_dirs=False)
    assert str(port_err.value) == str(jax_err.value)
    assert Trainer(args, synthetic_sizes=(64, 32), make_dirs=False,
                   device="cpu").pipeline.dataset.synthetic


def test_make_dirs_false_creates_nothing(tmp_path, monkeypatch):
    """`make_dirs=False` names the output directory but creates nothing, and
    an epoch's record writes nothing either; the default creates the
    directory with its hyperparameters and log."""
    monkeypatch.chdir(tmp_path)
    args = _args(tmp_path)
    before = sorted(os.listdir(tmp_path))
    t = Trainer(args, synthetic_sizes=(64, 32), make_dirs=False, device="cpu")
    t.state, _, _ = t._run_epoch(t.state, t.epoch_indices())
    t._record({"epoch": 1})
    assert t.output_dir == os.path.join("outputs", "simclr", "tiny", "run")
    assert sorted(os.listdir(tmp_path)) == before
    Trainer(args, synthetic_sizes=(64, 32), device="cpu")
    assert sorted(os.listdir(t.output_dir)) == ["hyperparameters.txt", "trainlogs.txt"]


def _trace_spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("start_epoch", [1, 2])
def test_profile_dir_traces_the_runs_second_epoch(start_epoch, tmp_path, monkeypatch,
                                                  capsys):
    """With SSV_TPU_PROFILE_DIR set, `train()` writes one Chrome trace, of
    the run's second epoch (start_epoch + 1, pinned before the loop; a run
    resumed at epoch 2 traces epoch 3) and of no other: the span `epoch <e>`
    and a span `step <s>` for each of its steps; then it says where."""
    monkeypatch.chdir(tmp_path)
    profile_dir = tmp_path / "profile"
    monkeypatch.setenv("SSV_TPU_PROFILE_DIR", str(profile_dir))
    t = Trainer(_args(tmp_path, epochs=start_epoch + 1, eval_every=100),
                synthetic_sizes=(64, 32), device="cpu")
    t.start_epoch = start_epoch
    t.train()
    traced = start_epoch + 1
    assert sorted(os.listdir(profile_dir)) == [f"epoch{traced}.rank0.json"]
    spans = _trace_spans(profile_dir / f"epoch{traced}.rank0.json")
    assert [s for s in spans if s.startswith("epoch ")] == [f"epoch {traced}"]
    steps = t.pipeline.steps_per_epoch
    assert sorted(s for s in spans if s.startswith("step ")) == \
        sorted(f"step {s}" for s in range(steps))
    assert f"Profiler trace written to {profile_dir / f'epoch{traced}.rank0.json'}" in \
        capsys.readouterr().out


def test_profile_dir_unset_writes_no_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SSV_TPU_PROFILE_DIR", raising=False)
    t = Trainer(_args(tmp_path, epochs=2, eval_every=100), synthetic_sizes=(64, 32),
                device="cpu")
    t.train()
    assert not any(f.endswith(".json") and f.startswith("epoch")
                   for _, _, files in os.walk(tmp_path) for f in files)
