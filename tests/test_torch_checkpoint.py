"""The port's checkpoints through its Trainer on the CPU: a round trip, the
task-dependent choice of `latest` and `best_model`, `train_safe` saving on
failure, and exact resume (an interrupted and resumed BYOL run equals the
run that was never stopped, bit for bit)."""

import os

import pytest
import torch
import yaml

import helpers
from ssv_tpu_torch.train.trainer import Trainer
from torch_helpers import small_resnet18, stage_fake_cifar

torch.set_num_threads(2)


class Stop(Exception):
    pass


def _trainer(tmp_path, monkeypatch, algo="byol", epochs=2, output="run", **args):
    """A Trainer on a tiny fake CIFAR-10 (64 train, 32 test images, 16x16
    views, batch 16: 4 steps an epoch) with a two-stage ResNet."""
    small_resnet18(monkeypatch)
    monkeypatch.chdir(tmp_path)
    data = tmp_path / "data"
    if not data.exists():
        stage_fake_cifar(str(data), n_train=64, n_test=32)
    cfg = helpers.mini_config(algo, epochs=epochs, batch_size=16)
    cfg["compute_dtype"] = "float32"
    cfg["data"]["root"] = str(data)
    cfg["data"]["transforms"]["train"]["random_resized_crop"]["size"] = [16, 16]
    cfg["data"]["transforms"]["test"]["center_crop"]["size"] = [16, 16]
    path = tmp_path / f"{algo}-{epochs}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return Trainer({"config": str(path), "algo": algo, "arch": "resnet18", "task": "train",
                    "output": output, "load": None, **args}, device="cpu")


def _tensors(trainer):
    """Every tensor of the trainer's state, by name."""
    s = trainer.state
    out = {f"model.{k}": v for k, v in s.model.state_dict().items()}
    for name, module in s.extra.items():
        out.update({f"{name}.{k}": v for k, v in module.state_dict().items()})
    for i, st in s.optimizer.state_dict()["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in st.items()})
    out["generator"] = trainer.generator.get_state()
    return out


def _assert_equal_states(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert a.state.step == b.state.step
    assert a.state.scheduler.state_dict() == b.state.scheduler.state_dict()


def test_checkpoint_roundtrip(tmp_path, monkeypatch):
    t = _trainer(tmp_path, monkeypatch)
    t.state, _, _ = t._run_epoch(t.state, t.pipeline.epoch_indices(t.generator))
    t.best_metric = 0.5
    t.save_checkpoint(epoch=1)
    assert os.path.isfile(os.path.join(t.output_dir, "best_model"))

    t2 = _trainer(tmp_path, monkeypatch, output="other")
    t2.load_checkpoint(t.output_dir)
    assert t2.best_metric == 0.5 and t2.start_epoch == 2
    assert t2.state.step == 4
    _assert_equal_states(t, t2)


@pytest.mark.parametrize("task,expect_step", [
    ("train", 1),          # resume: the rolling `latest`
    ("linear_eval", 0),    # inference: `best_model`, the reference's checkpoint
    ("get_features", 0),
])
def test_load_checkpoint_task_preference(task, expect_step, tmp_path, monkeypatch):
    t = _trainer(tmp_path, monkeypatch)
    t.save_checkpoint("best_model")
    idx = t.pipeline.epoch_indices(t.generator)[:1]
    t.state, _, _ = t._run_epoch(t.state, idx)
    t.save_checkpoint("latest")

    t2 = _trainer(tmp_path, monkeypatch, output="other")
    t2.args["task"] = task
    t2.load_checkpoint(t.output_dir)
    assert t2.state.step == expect_step
    with pytest.raises(FileNotFoundError):
        t2.load_checkpoint(str(tmp_path / "nowhere"))


def test_train_safe_saves_state_on_failure(tmp_path, monkeypatch):
    t = _trainer(tmp_path, monkeypatch)
    run_epoch = t._run_epoch

    def boom(state, idx_mat):
        if state.step >= 4:
            raise RuntimeError("injected failure")
        return run_epoch(state, idx_mat)

    t._run_epoch = boom
    with pytest.raises(RuntimeError, match="injected"):
        t.train_safe()
    assert os.path.isfile(os.path.join(t.output_dir, "latest"))
    # a fresh trainer resumes from the flushed state, at epoch 2
    t2 = _trainer(tmp_path, monkeypatch, output="other", load=t.output_dir)
    assert t2.start_epoch == 2 and t2.state.step == 4
    _assert_equal_states(t, t2)


def test_exact_resume_byol(tmp_path, monkeypatch):
    """Two epochs straight against one epoch, a stop, a new Trainer with
    `load`, and the second epoch: the same losses, weights (the EMA target's
    included), optimizer state, generator state and probe accuracy."""
    straight = _trainer(tmp_path, monkeypatch, output="straight")
    acc = straight.train()

    cut = _trainer(tmp_path, monkeypatch, output="cut")

    def stop_at_epoch_2(state, trainer, epoch):
        if epoch == 2:
            raise Stop
        return state

    cut.algorithm.pre_epoch = stop_at_epoch_2
    with pytest.raises(Stop):
        cut.train_safe()
    assert cut.state.step == 4
    for name in ("latest", "best_model"):
        assert os.path.isfile(os.path.join(cut.output_dir, name))

    resumed = _trainer(tmp_path, monkeypatch, output="resumed", load=cut.output_dir)
    assert resumed.start_epoch == 2
    assert resumed.train() == acc
    assert [e["epoch"] for e in resumed.epoch_stats] == [2]
    assert resumed.epoch_stats[0]["losses"] == straight.epoch_stats[1]["losses"]
    _assert_equal_states(straight, resumed)
    assert resumed.state.step == 8
