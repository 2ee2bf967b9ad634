"""The port's all-algorithm sweep (`ssv_tpu_torch.tools.sweep`) against the
JAX package's `scripts/tpu_sweep.py`, loaded by path, on the CPU: its rows,
its configs, two rows run at a tiny size, the floor guard and the floors
it writes."""

import json
import sys

import pytest
import torch
import yaml

import helpers
from ssv_tpu_torch.tools import sweep
from torch_helpers import load_script, redirect_tmp

torch.set_num_threads(2)

ALGOS = ["simclr", "moco", "byol", "relic", "simsiam", "barlow", "swav", "pirl",
         "deep_cluster", "sela", "dino"]


@pytest.fixture(scope="module")
def jax_sweep():
    return load_script("tpu_sweep")


def test_sweep_rows_match_jax(jax_sweep):
    assert sweep.SWEEP == jax_sweep.SWEEP
    assert sweep.FLOOR_RATIO == jax_sweep.FLOOR_RATIO


@pytest.mark.parametrize("algo", ALGOS)
def test_mini_config_matches_helpers(algo):
    """The port's copy of `tests/helpers.mini_config`, for every algorithm."""
    for epochs, batch in ((1, 16), (3, 256)):
        assert sweep.mini_config(algo, epochs=epochs, batch_size=batch) == \
            helpers.mini_config(algo, epochs=epochs, batch_size=batch)


def test_sweep_configs_match_jax(jax_sweep, tmp_path, monkeypatch, capsys):
    """Each row's config, as the JAX sweep writes it for its Trainer (read
    by a Trainer stub, every row then an error row) and as the port's
    `sweep_config` builds it, at 3 epochs."""
    import ssv_tpu.train

    monkeypatch.chdir(tmp_path)
    redirect = redirect_tmp(monkeypatch, jax_sweep, tmp_path)
    seen = {}

    def stub(args, **kwargs):
        with open(redirect.moved(args["config"])) as f:
            seen[args["config"]] = (yaml.safe_load(f), args["arch"], kwargs)
        raise RuntimeError("captured")

    monkeypatch.setattr(ssv_tpu.train, "Trainer", stub)
    monkeypatch.setattr(sys, "argv", ["tpu_sweep.py", "--no-write"])
    jax_sweep.main()
    capsys.readouterr()
    assert len(seen) == len(sweep.SWEEP)
    for name, algo, arch, batch, overrides in sweep.SWEEP:
        cfg, jax_arch, kwargs = seen[f"/tmp/sweep_{name.replace('+', '_')}/cfg.yaml"]
        assert sweep.sweep_config(algo, 3, batch, overrides) == cfg, name
        assert jax_arch == arch and kwargs == {"synthetic_sizes": sweep.SIZES}


def _cpu_sweep(tmp_path, *extra):
    """simclr and sela for 2 epochs on `tiny` at 128 / 64 images, batch 16."""
    return sweep.main(["2", "--only", "simclr,sela", "--device", "cpu", "--n-train", "128",
                       "--n-test", "64", "--arch", "tiny", "--batch", "16",
                       "--table", str(tmp_path / "sweep" / "table.md"), *extra])


def test_two_rows_on_the_cpu(tmp_path, monkeypatch, capsys):
    """`--no-write`: both rows run, finite losses, a KNN, no table and no
    floors written; `--results` holds the run."""
    monkeypatch.chdir(tmp_path)
    results = tmp_path / "results.json"
    rc = _cpu_sweep(tmp_path, "--no-write", "--results", str(results),
                    "--floors", str(tmp_path / "floors.json"))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    run = json.loads(results.read_text())
    assert rc == 0 and run["card"] == "CPU" and run["epochs"] == 2
    assert printed == run["results"]
    assert [r["algo"] for r in printed] == ["simclr", "sela"]
    for r in printed:
        assert "error" not in r and len(r["losses"]) == 2 and 0.0 <= r["knn"] <= 1.0
        assert r["steps"] == 2 * (128 // 16) and r["photometric_launches"] == 0
    assert not (tmp_path / "sweep" / "table.md").exists()
    assert not (tmp_path / "floors.json").exists()


@pytest.mark.parametrize("img_per_sec,floor,regressed", [
    (80, 100, False), (79, 100, True), (500, 100, False), (10, None, False)])
def test_regressions_at_the_floor_ratio(img_per_sec, floor, regressed):
    floors = {} if floor is None else {"simclr": floor}
    got = sweep.regressions([{"algo": "simclr", "img_per_sec": img_per_sec}], floors)
    assert bool(got) == regressed
    assert sweep.regressions([{"algo": "sela", "error": "boom"}], floors) == ["sela: boom"]


def test_floor_guard_exits_1_below_its_floor(tmp_path, monkeypatch, capsys):
    """A floor far above the CPU's img/s in a temp floors file: exit 1 and
    the regression named; the table is written all the same."""
    monkeypatch.chdir(tmp_path)
    floors = tmp_path / "floors.json"
    floors.write_text(json.dumps({"card": "test", "floors": {"simclr": 10**9}}))
    rc = _cpu_sweep(tmp_path, "--floors", str(floors))
    out = capsys.readouterr().out
    assert rc == 1
    assert "THROUGHPUT REGRESSIONS" in out and "simclr:" in out.split("REGRESSIONS")[1]
    assert "sela:" not in out.split("REGRESSIONS")[1]
    assert "| simclr | tiny | 16 |" in (tmp_path / "sweep" / "table.md").read_text()


def test_update_floors_writes_the_run_and_its_card(tmp_path, monkeypatch, capsys):
    """`--update-floors` writes this run's img/s and the card line (and
    passes whatever the old floors were); `--floors-from` writes the
    slowest of several runs."""
    monkeypatch.chdir(tmp_path)
    floors = tmp_path / "floors.json"
    floors.write_text(json.dumps({"card": "old", "floors": {"simclr": 10**9}}))
    results = tmp_path / "r1.json"
    rc = _cpu_sweep(tmp_path, "--floors", str(floors), "--update-floors",
                    "--results", str(results))
    capsys.readouterr()
    run = json.loads(results.read_text())
    written = json.loads(floors.read_text())
    assert rc == 0
    assert written["card"] == "CPU" and written["runs"] == 1 and written["epochs"] == 2
    assert written["floors"] == {r["algo"]: r["img_per_sec"] for r in run["results"]}
    assert written["ratio"] == sweep.FLOOR_RATIO

    other = {"card": "CPU", "epochs": 2, "results": [
        {"algo": "simclr", "img_per_sec": 1}, {"algo": "sela", "img_per_sec": 10**9},
        {"algo": "dino", "error": "boom"}]}
    (tmp_path / "r2.json").write_text(json.dumps(other))
    assert sweep.main(["--floors", str(floors), "--floors-from", str(results),
                       str(tmp_path / "r2.json")]) == 0
    slowest = json.loads(floors.read_text())
    assert slowest["runs"] == 2 and slowest["floors"] == {
        "simclr": 1, "sela": written["floors"]["sela"]}
