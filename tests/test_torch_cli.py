"""The port's entry point, `python -m ssv_tpu_torch.main`, end to end on the
CPU, and the rule that the port never imports JAX."""

import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import helpers
from ssv_tpu_torch import main as cli
from torch_helpers import stage_fake_cifar

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ssv_tpu_torch")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_cli_trains_simclr_resnet18(tmp_path):
    stage_fake_cifar(str(tmp_path / "data"))
    with open(os.path.join(REPO, "configs", "simclr.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(epochs=1, eval_every=1)
    cfg["data"].update(batch_size=32, root=str(tmp_path / "data"))
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))

    proc = subprocess.run(
        [sys.executable, "-m", "ssv_tpu_torch.main", "-c", "c.yaml", "-m", "resnet18",
         "-a", "simclr", "-t", "train", "-o", "run", "--device", "cpu"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = (tmp_path / "outputs" / "simclr" / "resnet18" / "run" / "trainlogs.txt").read_text()
    loss = re.search(r"\[loss\] (\S+)", log)
    assert loss and math.isfinite(float(loss.group(1))), log
    acc = re.search(r"\[accuracy\] (\S+)", log)
    assert acc and 0.0 <= float(acc.group(1)) <= 1.0, log
    assert "Platform: cpu" in proc.stdout


def _small_config(tmp_path, epochs):
    """configs/byol.yaml on the fake CIFAR: 16x16 views, batch 16, a probe
    of 2 epochs, float32."""
    with open(os.path.join(REPO, "configs", "byol.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(epochs=epochs, eval_every=1, compute_dtype="float32")
    cfg["linear_eval"].update(epochs=2, batch_size=16)
    cfg["data"].update(batch_size=16, root=str(tmp_path / "data"))
    cfg["data"]["transforms"]["train"]["random_resized_crop"]["size"] = [16, 16]
    cfg["data"]["transforms"]["test"]["center_crop"]["size"] = [16, 16]
    path = tmp_path / f"byol-{epochs}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(path)


def test_cli_train_then_inference_tasks(tmp_path, monkeypatch, capsys):
    """train, then linear_eval -l and get_features -l on the run, as the JAX
    CLI's end-to-end test drives main.py: checkpoints, the probe's log line,
    the task-dependent checkpoint and the four binary .npy files."""
    from torch_helpers import small_resnet18

    small_resnet18(monkeypatch)
    stage_fake_cifar(str(tmp_path / "data"), n_train=64, n_test=32)
    monkeypatch.chdir(tmp_path)
    cfg = _small_config(tmp_path, epochs=1)

    def drive(*argv):
        return cli.main(["-c", cfg, "-m", "resnet18", "-a", "byol", "--device", "cpu", *argv])

    trainer = drive("-t", "train", "-o", "run")
    run = tmp_path / "outputs" / "byol" / "resnet18" / "run"
    for name in ("latest", "best_model", "latest.meta.json", "best_model.meta.json"):
        assert (run / name).is_file(), name
    assert 0.0 <= trainer.linear_eval_stats["accuracy"] <= 1.0
    assert "Test linear eval accuracy" in (run / "trainlogs.txt").read_text()
    capsys.readouterr()

    with pytest.raises(ValueError, match="--load"):
        drive("-t", "linear_eval", "-o", "noload")

    drive("-t", "linear_eval", "-o", "lin", "-l", str(run))
    out = capsys.readouterr().out
    assert f"Loaded checkpoint from {run / 'best_model'}" in out
    assert "Test linear eval accuracy" in out

    drive("-t", "get_features", "-o", "feat", "-l", str(run))
    assert f"Loaded checkpoint from {run / 'best_model'}" in capsys.readouterr().out
    feat = tmp_path / "outputs" / "byol" / "resnet18" / "feat"
    for name, shape in [("train_fvecs", (64, 128)), ("train_gt", (64,)),
                        ("test_fvecs", (32, 128)), ("test_gt", (32,))]:
        assert np.load(feat / f"{name}.npy").shape == shape, name
    # BYOL's features are the online tower's L2-normalized output
    np.testing.assert_allclose(np.linalg.norm(np.load(feat / "test_fvecs.npy"), axis=1),
                               1.0, rtol=1e-5)


def test_cli_resume_continues_from_latest(tmp_path, monkeypatch, capsys):
    """train -l resumes from the run's `latest` and trains only the epochs
    left."""
    from torch_helpers import small_resnet18

    small_resnet18(monkeypatch)
    stage_fake_cifar(str(tmp_path / "data"), n_train=64, n_test=32)
    monkeypatch.chdir(tmp_path)
    argv = ["-m", "resnet18", "-a", "byol", "--device", "cpu", "-t", "train"]
    first = cli.main(["-c", _small_config(tmp_path, epochs=1), *argv, "-o", "run"])
    run = tmp_path / "outputs" / "byol" / "resnet18" / "run"
    capsys.readouterr()

    resumed = cli.main(["-c", _small_config(tmp_path, epochs=2), *argv, "-o", "more",
                        "-l", str(run)])
    assert f"Loaded checkpoint from {run / 'latest'}" in capsys.readouterr().out
    assert [e["epoch"] for e in resumed.epoch_stats] == [2]
    assert resumed.state.step == 2 * first.state.step == 8


@pytest.mark.parametrize("entry", ["cli", "trainer", "cli_explicit_cuda"])
def test_no_card_raises_unless_cpu_asked_for(entry, tmp_path, monkeypatch):
    """Without a card the entry points stop before any data is built; they
    never fall back to the CPU on their own."""
    from ssv_tpu_torch.train import trainer as trainer_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    built = []
    monkeypatch.setattr(trainer_mod, "DataPipeline", lambda *a, **k: built.append(a))
    argv = ["-c", "missing.yaml", "-m", "resnet18", "-a", "simclr", "-t", "train", "-o", "run"]
    with pytest.raises(RuntimeError, match="--device cpu"):
        if entry == "trainer":
            trainer_mod.Trainer({"config": "missing.yaml", "algo": "simclr",
                                 "arch": "resnet18", "output": "run"})
        else:
            cli.main(argv + (["--device", "cuda"] if entry == "cli_explicit_cuda" else []))
    assert built == [] and not (tmp_path / "outputs").exists()


def test_unported_algorithm_and_arch_raise():
    """Every algorithm and every arch of the JAX package is ported, with the
    same feature widths, and the CLI offers the same archs as main.py (not
    the test backbone `tiny`); an unknown name still raises."""
    from ssv_tpu.models.registry import NETWORKS as JAX_NETWORKS
    from ssv_tpu.train.registry import ALGORITHMS as JAX_ALGORITHMS
    from ssv_tpu_torch.models import registry
    from ssv_tpu_torch.train.registry import ALGORITHMS, build_algorithm

    assert set(ALGORITHMS) == set(JAX_ALGORITHMS)
    assert {k: v["dim"] for k, v in registry.NETWORKS.items()} == \
        {k: v["dim"] for k, v in JAX_NETWORKS.items()}
    assert not hasattr(registry, "NOT_PORTED")
    assert set(cli.NETWORKS) == set(registry.NETWORKS) - {"tiny"}
    with pytest.raises(ValueError, match="Unknown algorithm"):
        build_algorithm("nope", helpers.mini_config("simclr"), "resnet18", None, "cpu")
    with pytest.raises(ValueError, match="Unknown arch"):
        registry.build_encoder("resnet200", {})


def test_port_imports_no_jax():
    """Every module of the package imports without JAX, the JAX package or
    the JAX system's root modules (`__graft_entry__`, `bench`), and none
    names them in an import."""
    modules = sorted(
        "ssv_tpu_torch." + os.path.relpath(os.path.join(d, f), PKG)[:-3].replace(os.sep, ".")
        for d, _, files in os.walk(PKG) for f in files if f.endswith(".py"))
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ssv_tpu', '__graft_entry__', "
            "'bench'))\n"
            "assert not bad, bad\n"
            "print(len(" + repr(modules) + "))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) == len(modules) > 20
    for m in modules:
        path = os.path.join(REPO, *m.split(".")) + ".py"
        if not os.path.isfile(path):
            path = os.path.join(REPO, *m.split("."), "__init__.py")
        src = open(path).read()
        assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax|orbax|ssv_tpu|"
                             r"__graft_entry__|bench)\b", src, re.M), m


@pytest.mark.parametrize("algo,width", [("pirl", 128), ("deep_cluster", 512)])
def test_cli_pirl_and_deep_cluster_train_then_inference_tasks(algo, width, tmp_path,
                                                              monkeypatch):
    """configs/pirl.yaml and configs/deep_cluster.yaml at their widths
    (ResNet-18, 32x32 views, PIRL's four 16x16 patches; PIRL's 1,000
    negatives cut to the 128-image split's reach), one epoch on the staged
    fake CIFAR, batch 16, in the default bf16 autocast: `train` (PIRL's bank
    filled at `pre_train`, DeepCluster's K-means of 300 x 10 at the epoch's
    start, KNN, checkpoints, the probe), then `linear_eval -l` and
    `get_features -l` with the config's `linear_eval.input_dim` features.
    (Smaller patches are no cut here: on the CPU, bf16 autocast gives a
    stride-2 convolution over a 1x1 map, which 8x8 patches reach, an
    undefined weight gradient.)"""
    stage_fake_cifar(str(tmp_path / "data"))
    monkeypatch.chdir(tmp_path)
    with open(os.path.join(REPO, "configs", f"{algo}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(epochs=1, eval_every=1)
    if algo == "pirl":
        cfg.update(num_negatives=100)
    cfg["linear_eval"].update(epochs=2)
    cfg["data"].update(batch_size=16, root=str(tmp_path / "data"))
    path = tmp_path / f"{algo}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    assert cfg["linear_eval"]["input_dim"] == width

    def drive(*argv):
        return cli.main(["-c", str(path), "-m", "resnet18", "-a", algo, "--device", "cpu",
                         *argv])

    trainer = drive("-t", "train", "-o", "run")
    run = tmp_path / "outputs" / algo / "resnet18" / "run"
    assert (run / "latest").is_file() and (run / "best_model").is_file()
    losses = trainer.epoch_stats[0]["losses"]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert 0.0 <= trainer.linear_eval_stats["accuracy"] <= 1.0
    extra = trainer.state.extra
    if algo == "pirl":
        assert torch.isfinite(extra["bank"].data).all() and extra["bank"].data.shape == (128, 128)
    else:
        assert 0 <= extra["pseudo_labels"].labels.min() <= extra["pseudo_labels"].labels.max() < 10
    assert drive("-t", "linear_eval", "-o", "lin", "-l", str(run)).linear_eval_stats
    drive("-t", "get_features", "-o", "feat", "-l", str(run))
    feat = tmp_path / "outputs" / algo / "resnet18" / "feat"
    for name, shape in [("train_fvecs", (128, width)), ("train_gt", (128,)),
                        ("test_fvecs", (256, width)), ("test_gt", (256,))]:
        assert np.load(feat / f"{name}.npy").shape == shape, name
    np.testing.assert_allclose(np.linalg.norm(np.load(feat / "test_fvecs.npy"), axis=1),
                               1.0, rtol=1e-5)
