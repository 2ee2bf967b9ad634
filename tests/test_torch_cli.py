"""The port's entry point, `python -m ssv_tpu_torch.main`, end to end on the
CPU, and the rule that the port never imports JAX."""

import math
import os
import re
import subprocess
import sys

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
         "-a", "simclr", "-t", "train", "-o", "run"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = (tmp_path / "outputs" / "simclr" / "resnet18" / "run" / "trainlogs.txt").read_text()
    loss = re.search(r"\[loss\] (\S+)", log)
    assert loss and math.isfinite(float(loss.group(1))), log
    acc = re.search(r"\[accuracy\] (\S+)", log)
    assert acc and 0.0 <= float(acc.group(1)) <= 1.0, log
    assert "Platform: cpu" in proc.stdout


@pytest.mark.parametrize("argv", [["-t", "linear_eval", "-l", "x"],
                                  ["-t", "get_features", "-l", "x"],
                                  ["-t", "train", "-l", "x"]])
def test_unported_tasks_exit_with_roadmap_pointer(argv):
    with pytest.raises(SystemExit, match=r"not yet ported .*slice A, item 9"):
        cli.main(["-c", "unused.yaml", "-m", "resnet18", "-a", "simclr", *argv])


def test_unported_algorithm_and_arch_raise():
    from ssv_tpu_torch.models.registry import build_encoder
    from ssv_tpu_torch.train.registry import build_algorithm

    with pytest.raises(NotImplementedError, match="slice B"):
        build_algorithm("byol", helpers.mini_config("byol"), "resnet18", None, "cpu")
    with pytest.raises(NotImplementedError, match="slice C"):
        build_encoder("resnet50", {})


def test_port_imports_no_jax():
    """Every module of the package imports without JAX or the JAX package."""
    modules = sorted(
        "ssv_tpu_torch." + os.path.relpath(os.path.join(d, f), PKG)[:-3].replace(os.sep, ".")
        for d, _, files in os.walk(PKG) for f in files if f.endswith(".py"))
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ssv_tpu'))\n"
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
        assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax|orbax|ssv_tpu)\b",
                             src, re.M), m
