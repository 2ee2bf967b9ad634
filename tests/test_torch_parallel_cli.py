"""The port's CLI across ranks: `python -m torch.distributed.run
--nproc_per_node 2 -m ssv_tpu_torch.main -d cpu` (gloo), SimCLR ResNet-18
on the staged fake CIFAR (16x16 train views), float32, 2 epochs; the same
run stopped at epoch 2's start and resumed with `-l`, each rank recording
what it saw (`torch_helpers.cli_rank`); a resume at 1 rank; and the dry run
of ssv_tpu_torch/parallel/dryrun.py at 2 and 4 ranks. Each launch is given
`LAUNCH_TIMEOUT_S`."""

import glob
import json
import os
import subprocess
import sys

import pytest
import torch
import yaml

import helpers
import torch_helpers as th

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 180


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]))
    env.pop("WANDB_MODE", None)
    env.pop("WANDB_API_KEY", None)
    return env


def _launch(cwd, args, nproc=2):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", *args]
    return subprocess.run(cmd, cwd=cwd, env=_env(), capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The full run, the stopped run and its resume, each rank's record."""
    tmp = tmp_path_factory.mktemp("cli")
    th.stage_fake_cifar(str(tmp / "data"), n_train=64, n_test=64)
    cfg = helpers.mini_config("simclr", epochs=2, batch_size=16)
    cfg["compute_dtype"] = "float32"
    cfg["data"]["root"] = str(tmp / "data")
    cfg["data"]["transforms"]["train"]["random_resized_crop"]["size"] = [16, 16]
    cfg["linear_eval"] = {"epochs": 2, "batch_size": 16, "lr": 0.1}
    cfg_path = tmp / "simclr.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    helper = os.path.join(ROOT, "tests", "torch_helpers.py")
    main = ["-c", str(cfg_path), "-m", "resnet18", "-a", "simclr", "-t", "train", "-d", "cpu"]

    proc = _launch(tmp, ["-m", "ssv_tpu_torch.main", *main, "-o", "full"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = {"full-stdout": proc.stdout, "full": [
        json.loads(line) for line in
        (tmp / "outputs/simclr/resnet18/full/epoch_stats.jsonl").read_text().splitlines()]}
    for name, stop, extra in (("stopped", 2, ["-o", "stopped"]),
                              ("resumed", 0, ["-o", "resumed", "-l",
                                              "outputs/simclr/resnet18/stopped"])):
        proc = _launch(tmp, [helper, "cli", str(tmp / f"{name}-rank"), str(stop), *main, *extra])
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        out[name] = [json.loads((tmp / f"{name}-rank{r}.json").read_text()) for r in range(2)]
    out["tmp"], out["main"] = tmp, main
    return out


def _losses(record, epoch):
    return next(e["losses"] for e in record["epoch_stats"] if e["epoch"] == epoch)


def test_two_rank_run_trains_and_rank_0_records(runs):
    """The entry point under torchrun trains 4 steps an epoch on the global
    batch of 16 (8 a rank) for 2 epochs, with finite losses; rank 0 alone
    logs and records; both ranks of the resumed run reach the same KNN
    accuracy and probe."""
    full = runs["full"]
    assert [e["steps"] for e in full] == [4, 4]
    assert all(0.0 < x < 100.0 for e in full for x in e["losses"])
    out = runs["full-stdout"]
    assert out.count("Beginning training.") == 1 and "ranks: 2" in out
    resumed = runs["resumed"]
    assert [r["world"] for r in resumed] == [2, 2]
    assert resumed[0]["best_metric"] == resumed[1]["best_metric"]
    assert resumed[0]["probe"] == resumed[1]["probe"] and 0.0 <= resumed[0]["probe"] <= 1.0


def test_one_checkpoint_for_the_ranks(runs):
    """The stopped run's directory holds one `best_model` and one `latest`
    (rank 0's), with each rank's generator."""
    d = runs["tmp"] / "outputs/simclr/resnet18/stopped"
    names = sorted(os.path.basename(p) for p in glob.glob(str(d / "*")))
    assert [n for n in names if not n.endswith((".txt", ".jsonl", ".json"))] == \
        ["best_model", "latest"], names
    blob = torch.load(d / "latest", weights_only=True)
    assert len(blob["generators"]) == 2
    assert not torch.equal(blob["generators"][0], blob["generators"][1])
    assert all(r["stopped"] for r in runs["stopped"])


def test_resume_is_exact(runs):
    """Epoch 1 of the stopped run and epoch 2 of its resume, on both ranks,
    have the losses of the run never stopped."""
    full = {"epoch_stats": runs["full"]}
    for r in range(2):
        assert _losses(runs["stopped"][r], 1) == _losses(full, 1)
        assert _losses(runs["resumed"][r], 2) == _losses(full, 2)


def test_resume_at_another_world_size_raises(runs):
    """The 2-rank checkpoint resumed by one process stops with the world
    size error."""
    proc = subprocess.run(
        [sys.executable, "-m", "ssv_tpu_torch.main", *runs["main"], "-o", "one",
         "-l", "outputs/simclr/resnet18/stopped"],
        cwd=runs["tmp"], env=_env(), capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode != 0
    assert "saved by 2 rank(s)" in proc.stderr, proc.stderr[-2000:]


def test_dryrun_at_two_ranks(tmp_path):
    """ssv_tpu_torch/parallel/dryrun.py's phases at 2 ranks on gloo (the
    DPxTP phase at 1 x 2)."""
    proc = _launch(tmp_path, ["-m", "ssv_tpu_torch.parallel.dryrun", "--device", "cpu"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for phase in ("sync SimCLR", "DPxTP SwAV: 1 x 2 ranks", "MoCo", "DINO"):
        assert f"[dryrun] {phase}" in proc.stdout, proc.stdout


def test_dryrun_at_four_ranks(tmp_path):
    """The dry run's phases at 4 ranks on gloo, the DPxTP phase at 2 x 2:
    its step held against one process's, the tower the same on every rank
    and each shard across its data group."""
    proc = _launch(tmp_path, ["-m", "ssv_tpu_torch.parallel.dryrun", "--device", "cpu"],
                   nproc=4)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for phase in ("sync SimCLR", "DPxTP SwAV: 2 x 2 ranks", "MoCo", "DINO"):
        assert f"[dryrun] {phase}" in proc.stdout, proc.stdout
    assert "[dryrun] every phase passed at 4 ranks" in proc.stdout
