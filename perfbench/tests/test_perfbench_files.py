"""BENCHMARK.json and the files it names: their shapes, names and units,
and that the harness finds a cell, a configuration, a traffic mix and a
metric reader by file name alone."""

import importlib
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import compare, harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expan|experts")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_limits(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert bench["paths"] == ["perfbench"] and bench["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_every_entry_names_files_that_parse(bench, kind):
    for entry in bench[kind]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
        if kind == "configs":
            assert set(entry) == {"name", "source", "file", "reduced", "why"}
            cfg = json.loads((ROOT / entry["file"]).read_text())
            assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
            assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
            assert not any(WIDTHS.search(k) for k in entry["reduced"])
            assert cfg["source"] == entry["source"] and len(entry["source"]) <= 200
            assert any(w["config"] == entry["name"] for w in bench["workloads"])
        else:
            assert set(entry) == {"name", "config", "traffic", "chips", "why"}
            assert entry["chips"] in (1, 4) and NAME.match(entry["traffic"])
            json.loads((ROOT / "perfbench" / "workloads" / f"{entry['traffic']}.json").read_text())
            limits = json.loads(
                (ROOT / "perfbench" / "limits" / f"{entry['name']}.json").read_text())
            assert any(number in limits for number in compare.NUMBERS)
            for number in compare.NUMBERS:
                if number in limits:
                    lim = limits[number]
                    assert lim["lower"] < lim["limit"] < lim["upper"]
                else:
                    assert limits["not_compared"][number]["why"]


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        module = importlib.import_module(f"perfbench.metrics.{m['name']}")
        assert callable(module.read)


def test_a_new_cell_is_files_and_an_entry(tmp_path, bench):
    """A traffic file and a BENCHMARK.json entry dropped into a copy are
    picked up with no change to the harness's code."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((ROOT / "perfbench/workloads/cifar10_shaped_epochs.json").read_text())
    traffic["n_train"] = 20480
    (tmp_path / "perfbench/workloads/small_epochs.json").write_text(json.dumps(traffic))
    new = dict(bench)
    new["workloads"] = bench["workloads"] + [
        {"name": "byol_small", "config": "byol_resnet18_cifar10", "traffic": "small_epochs",
         "chips": 1, "why": "a test's cell"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cell = harness.Cell("byol_small", root=tmp_path)
    assert cell.traffic["n_train"] == 20480 and cell.steps_per_epoch == 40
    assert cell.cfg["algo"] == "byol" and cell.limits is None
    assert [m["name"] for m in cell.metrics(traced=False)] == [
        m["name"] for m in bench["end_to_end"]]
    with pytest.raises(KeyError):
        harness.Cell("no_such_cell", root=tmp_path)
