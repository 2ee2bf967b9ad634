"""The port's checkpoints through its Trainer on the CPU: a round trip, the
task-dependent choice of `latest` and `best_model`, `train_safe` saving on
failure, exact resume (an interrupted and resumed BYOL, MoCo, SeLA, PIRL
or DeepCluster run equals the run that was never stopped, bit for bit), and a dropped Trainer
freeing its model and dataset."""

import gc
import os
import sys
import types
import weakref

import pytest
import torch
import yaml

import helpers
from ssv_tpu_torch.train.trainer import Trainer
from torch_helpers import small_resnet18, stage_fake_cifar

torch.set_num_threads(2)


class Stop(Exception):
    pass


def _trainer(tmp_path, monkeypatch, algo="byol", epochs=2, output="run", cfg_extra=None,
             **args):
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
    views = cfg["data"]["transforms"]
    views["aug" if algo == "sela" else "train"]["random_resized_crop"]["size"] = [16, 16]
    views["std" if algo == "sela" else "test"]["center_crop"]["size"] = [16, 16]
    cfg.update(cfg_extra or {})
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


# MoCo: a queue of 40 rows, pushed across its end within an epoch; SeLA in
# the reference mode, which threads alpha and beta through each sweep; PIRL
# with 16x16 views in four 8x8 patches and 20 negatives of 64 bank rows;
# DeepCluster relabelling at each epoch's start
STATEFUL = [("moco", {"queue_size": 40}),
            ("sela", {"self_label_mode": "reference", "self_label_iters": 5}),
            ("pirl", {"patch_size": 8, "num_negatives": 20}),
            ("deep_cluster", {})]


@pytest.mark.parametrize("algo,cfg_extra", STATEFUL,
                         ids=["moco", "sela", "pirl", "deep_cluster"])
def test_exact_resume_stateful(algo, cfg_extra, tmp_path, monkeypatch):
    """As `test_exact_resume_byol`, for the state that is neither weights
    nor optimizer: MoCo's key tower, queue and pointer; SeLA's alpha, beta,
    pseudo-labels and best head (relabelled at `pre_train` and at epoch 1's
    start, so the resumed run starts from the checkpoint's labels); PIRL's
    bank (filled at `pre_train`, which the resumed run skips); DeepCluster's
    pseudo-labels (clustered anew at epoch 2's start from the restored
    weights)."""
    kw = dict(algo=algo, cfg_extra=cfg_extra)
    straight = _trainer(tmp_path, monkeypatch, output="straight", **kw)
    acc = straight.train()

    cut = _trainer(tmp_path, monkeypatch, output="cut", **kw)
    pre_epoch = cut.algorithm.pre_epoch

    def stop_at_epoch_2(state, trainer, epoch):
        if epoch == 2:
            raise Stop
        return pre_epoch(state, trainer, epoch)

    cut.algorithm.pre_epoch = stop_at_epoch_2
    with pytest.raises(Stop):
        cut.train_safe()
    resumed = _trainer(tmp_path, monkeypatch, output="resumed", load=cut.output_dir, **kw)
    assert resumed.start_epoch == 2
    assert resumed.train() == acc
    assert resumed.epoch_stats[0]["losses"] == straight.epoch_stats[1]["losses"]
    _assert_equal_states(straight, resumed)
    extra = resumed.state.extra
    if algo == "moco":
        assert int(extra["queue"].ptr) == (8 * 16) % 40
    elif algo == "sela":
        assert straight.algorithm.sl_epochs == {0, 1}
        assert len(extra["self_label"].pseudo_labels.unique()) > 1
    elif algo == "pirl":
        assert torch.isfinite(extra["bank"].data).all()
        assert (extra["bank"].data.norm(dim=1) > 0).all()
    else:
        labels = extra["pseudo_labels"].labels
        assert labels.shape == (64,) and 0 <= labels.min() <= labels.max() < 4


def test_dropped_trainer_frees_its_tensors(tmp_path, monkeypatch):
    """A Trainer that trained a step and is dropped leaves nothing alive:
    weak references to its model and its dataset tensor die at
    `gc.collect()`. With a wandb package installed whose `init` fails and
    keeps the exception (as wandb's error reporting does, and with it every
    frame up the stack), the Trainer does not call it unless the
    environment configures wandb, so nothing of the Trainer is kept."""
    from ssv_tpu_torch.utils import logging as port_logging

    kept = []

    def failing_init(**kwargs):
        try:
            raise RuntimeError("wandb api_key not configured")
        except RuntimeError as e:
            kept.append(e)          # the exception, its traceback and frames
            raise

    fake = types.SimpleNamespace(init=failing_init, run=None, log=lambda m: None)
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    monkeypatch.delenv("WANDB_MODE", raising=False)
    monkeypatch.setattr(port_logging, "_shim", None)

    trainer = _trainer(tmp_path, monkeypatch, algo="simclr")
    trainer.state, _, _ = trainer._run_epoch(
        trainer.state, trainer.pipeline.epoch_indices(trainer.generator)[:1])
    refs = [weakref.ref(trainer.state.model), weakref.ref(trainer.pipeline._train_images)]
    del trainer
    gc.collect()
    assert [r() for r in refs] == [None, None]
    assert kept == []
    assert port_logging.get_wandb()._wandb is None

    # configured: the run is wandb's, and its failure is the caller's to see
    monkeypatch.setenv("WANDB_MODE", "online")
    monkeypatch.setattr(port_logging, "_shim", None)
    with pytest.raises(RuntimeError, match="api_key"):
        port_logging.get_wandb().init(project="p", output_dir=str(tmp_path))
