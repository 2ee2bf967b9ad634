"""The port's quality runner (`ssv_tpu_torch.tools.quality_run`) against the
JAX package's `scripts/quality_run.py`, loaded by path, on the CPU: the
dotted `--set` keys, the config each run writes, a row's keys and its table
line, `--resume`, the NaN abort (no probe, strict JSON) and the
pseudo-label entropy."""

import json

import numpy as np
import pytest
import torch
import yaml

from ssv_tpu_torch.tools import quality_run
from ssv_tpu_torch.train import trainer as trainer_mod
from torch_helpers import load_script, redirect_tmp

torch.set_num_threads(2)


class Captured(Exception):
    pass


@pytest.fixture(scope="module")
def jax_qr():
    return load_script("quality_run")


SET_CASES = [
    ({"a": {"b": 1}}, "a.b", 2),
    ({"a": {"b": 1}}, "a.c.d", [0.5, 1]),
    ({}, "x.y.z", {"k": None}),
    ({"a": 3}, "a", "s"),
    ({"a": {"b": 1}}, "a.b.c", 4),        # descends into a scalar: ValueError
    ({"a": 1, "q": {"r": 2}}, "a.x", 0),  # likewise, one level up
]


@pytest.mark.parametrize("cfg,key,value", SET_CASES)
def test_set_dotted_matches_jax(cfg, key, value, jax_qr):
    import copy

    got, want = copy.deepcopy(cfg), copy.deepcopy(cfg)
    try:
        jax_qr._set_dotted(want, key, value)
    except ValueError as err:
        with pytest.raises(ValueError) as port_err:
            quality_run._set_dotted(got, key, value)
        assert str(port_err.value) == str(err)
    else:
        quality_run._set_dotted(got, key, value)
        assert got == want


CONFIG_CASES = [
    ("simclr", 40, "synth100", None, []),
    ("moco", 8, "shapes100", 128, ["loss_fn.temperature=0.2"]),
    ("byol", 3, "cifar10", 64, ["data.transforms.train.random_resized_crop.scale=[0.5, 1]",
                                "optimizer.lr=0.5"]),
    ("sela", 5, "synth100", 250, ["self_label_iters=3"]),
    ("dino", 2, "synth100", None, ["encoder.num_encoder_layers=2"]),
]


@pytest.mark.parametrize("algo,epochs,dataset,batch,sets", CONFIG_CASES)
def test_config_matches_jax(algo, epochs, dataset, batch, sets, jax_qr, tmp_path, monkeypatch):
    """The config file each runner hands its Trainer, for the same
    (algo, epochs, dataset, batch, --set) case, captured by a Trainer stub."""
    import ssv_tpu.train

    monkeypatch.chdir(tmp_path)
    redirect = redirect_tmp(monkeypatch, jax_qr, tmp_path)
    overrides = {k: yaml.safe_load(v) for k, v in (s.split("=", 1) for s in sets)}
    eval_every = max(1, epochs // 5)
    configs = {}

    def stub(name, read):
        def init(args, **kwargs):
            with open(read(args["config"])) as f:
                configs[name] = yaml.safe_load(f)
            raise Captured
        return init

    monkeypatch.setattr(ssv_tpu.train, "Trainer", stub("jax", redirect.moved))
    monkeypatch.setattr(trainer_mod, "Trainer", stub("port", lambda p: p))
    with pytest.raises(Captured):
        jax_qr.run_one(algo, epochs, dataset, eval_every, (64, 32), batch, overrides)
    with pytest.raises(Captured):
        quality_run.run_one(algo, epochs, dataset, eval_every, (64, 32), batch, overrides,
                            run_root=str(tmp_path / "port"), device="cpu")
    assert configs["port"] == configs["jax"]
    assert configs["port"]["epochs"] == epochs
    assert configs["port"]["data"]["dataset_name"] == dataset


def _tiny_run(tmp_path, algo="byol", epochs=2, **kw):
    """The port's run_one on `tiny` at 256 / 128 synth100 images, batch 64,
    a 1-epoch probe."""
    return quality_run.run_one(algo, epochs, "synth100", 1, (256, 128), 64,
                               {"linear_eval.epochs": 1}, arch="tiny", device="cpu",
                               run_root=str(tmp_path / "runs"), **kw)


def test_run_one_row_keys_match_jax(jax_qr, tmp_path, monkeypatch):
    """A 2-epoch BYOL run on `tiny` (backbone KNN on by default) returns the
    JAX runner's row keys, strict JSON, and its table line renders."""
    import ssv_tpu.train

    monkeypatch.chdir(tmp_path)
    redirect = redirect_tmp(monkeypatch, jax_qr, tmp_path)
    jax_trainer = ssv_tpu.train.Trainer
    monkeypatch.setattr(ssv_tpu.train, "Trainer", lambda args, **kw: jax_trainer(
        {**args, "config": redirect.moved(args["config"])}, **kw))
    want = jax_qr.run_one("byol", 2, "synth100", 1, (256, 128), 64,
                          {"linear_eval.epochs": 1}, arch="tiny")
    got = _tiny_run(tmp_path)
    assert set(got) == set(want)
    assert [e for e, _ in got["knn_curve"]] == [e for e, _ in want["knn_curve"]] == [1, 2]
    assert [e for e, _ in got["knn_backbone_curve"]] == [1, 2]
    assert 0.0 <= got["linear"] <= 1.0
    json.dumps(got, allow_nan=False)
    line = quality_run.table_row(got)
    assert line.startswith("| byol | 64 | 1:") and line.count("|") == 9
    assert f"| {got['best_knn']} | {got['best_knn_backbone']} | {got['linear']} |" in line


class Stop(Exception):
    pass


def _hook_pre_epoch(monkeypatch, hook):
    """Every algorithm the runner's Trainer builds gets `hook(state, epoch)`
    before its own `pre_epoch`."""
    build = trainer_mod.build_algorithm

    def build_with_hook(*args, **kwargs):
        algo = build(*args, **kwargs)
        pre_epoch = algo.pre_epoch

        def wrapped(state, trainer, epoch):
            hook(state, epoch)
            return pre_epoch(state, trainer, epoch)

        algo.pre_epoch = wrapped
        return algo

    monkeypatch.setattr(trainer_mod, "build_algorithm", build_with_hook)


def test_resume_picks_up_at_epoch_3(tmp_path, monkeypatch):
    """A 4-epoch run stopped at epoch 3's start resumes from the `latest`
    that epoch 2's eval saved: `resumed_at` 3, the curve from epoch 3."""
    monkeypatch.chdir(tmp_path)

    def stop_at_3(state, epoch):
        if epoch == 3:
            raise Stop

    with monkeypatch.context() as m:
        _hook_pre_epoch(m, stop_at_3)
        with pytest.raises(Stop):
            _tiny_run(tmp_path, algo="simclr", epochs=4)
    row = _tiny_run(tmp_path, algo="simclr", epochs=4, resume=True)
    assert row["resumed_at"] == 3
    assert [e for e, _ in row["knn_curve"]] == [3, 4]
    assert quality_run.table_row(row).startswith("| simclr | 64 | (resumed @3) 3:")


def test_nan_abort_runs_no_probe(tmp_path, monkeypatch, capsys):
    """Parameters filled with NaN at epoch 2's start: the run stops at epoch 2
    with `nan_at` 2 and the KNN of that state, `linear` is null, the probe is
    never called, and the printed line is strict JSON."""
    monkeypatch.chdir(tmp_path)

    def nan_at_2(state, epoch):
        if epoch == 2:
            with torch.no_grad():
                for p in state.model.parameters():
                    p.fill_(float("nan"))

    def no_probe(self):
        raise AssertionError("the linear probe ran on a non-finite state")

    _hook_pre_epoch(monkeypatch, nan_at_2)
    monkeypatch.setattr(trainer_mod.Trainer, "perform_linear_eval", no_probe)
    out = tmp_path / "q.md"
    rc = quality_run.main(["--algos", "simclr", "--epochs", "3", "--eval-every", "1",
                           "--dataset", "synth100", "--n-train", "256", "--n-test", "128",
                           "--batch", "64", "--arch", "tiny", "--tag", "nan",
                           "--device", "cpu", "--out", str(out)])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]

    def refuse(name):
        raise AssertionError(f"bare {name} in the JSON line")

    row = json.loads(lines[0], parse_constant=refuse)
    assert rc == 0 and len(lines) == 1
    assert row["nan_at"] == 2 and row["linear"] is None
    assert [e for e, _ in row["knn_curve"]] == [1, 2]
    assert "**loss NaN by epoch 2, aborted (terminal state)**" in out.read_text()


def test_error_row_and_exit_code(tmp_path, monkeypatch, capsys):
    """An algorithm that fails gives an `error` row, the next one still
    runs, and the runner exits 1."""
    monkeypatch.chdir(tmp_path)
    rc = quality_run.main(["--algos", "nope,simclr", "--epochs", "1", "--dataset",
                           "synth100", "--n-train", "128", "--n-test", "64", "--batch", "64",
                           "--arch", "tiny", "--tag", "err", "--device", "cpu",
                           "--set", "linear_eval.epochs=1", "--no-write"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert rc == 1 and [r["algo"] for r in rows] == ["nope", "simclr"]
    assert "error" in rows[0] and "error" not in rows[1]
    assert not (tmp_path / "outputs" / "quality" / "err.md").exists()


def _jax_entropy(st):
    """scripts/quality_run.py's `track_entropy` body on a state's extra."""
    counts = np.bincount(np.asarray(st["pseudo_labels"]))
    p = counts[counts > 0] / counts.sum()
    return round(float(-(p * np.log(p)).sum()), 3)


@pytest.mark.parametrize("algo", ["sela", "deep_cluster"])
def test_pseudo_entropy_matches_jax(algo):
    """The entropy of the pseudo-labels read from the port's state layout
    (`extra["self_label"].pseudo_labels`, `extra["pseudo_labels"].labels`)
    equals the JAX runner's formula on the same labels, and K is JAX's."""
    import jax.numpy as jnp

    from ssv_tpu.train.base import DataInfo as JaxDataInfo
    from ssv_tpu.train.registry import build_algorithm as jax_build
    from ssv_tpu_torch.tools.sweep import mini_config
    from ssv_tpu_torch.train.base import DataInfo
    from ssv_tpu_torch.train.registry import build_algorithm

    cfg = mini_config(algo, batch_size=16)
    port = build_algorithm(algo, cfg, "tiny", DataInfo(10, 64, 16, 4), "cpu")
    jax_algo = jax_build(algo, cfg, "tiny", JaxDataInfo(10, 64, 16, 4))
    state = port.init_state(torch.Generator().manual_seed(0))
    k = getattr(port, "num_clusters", getattr(port, "num_classes", None))
    labels = np.random.RandomState(0).choice(k, 64, p=np.linspace(1, 3, k) / np.linspace(
        1, 3, k).sum())
    target = state.extra["self_label"].pseudo_labels if algo == "sela" else \
        state.extra["pseudo_labels"].labels
    target.copy_(torch.from_numpy(labels))
    assert quality_run.pseudo_entropy(quality_run.pseudo_labels(state)) == \
        _jax_entropy({"pseudo_labels": jnp.asarray(labels)})
    assert k == getattr(jax_algo, "num_clusters", getattr(jax_algo, "num_classes", None))
