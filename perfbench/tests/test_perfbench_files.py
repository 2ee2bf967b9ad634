"""BENCHMARK.json and the files it names: their shapes, names and units,
and that the harness finds a cell, a configuration, a traffic mix, a
metric reader and a new algorithm (its views, optimizer and state) by file
name alone."""

import filecmp
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
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


# A stand-in algorithm, dropped into a copy of the benchmark as new files:
# four views in two sizes, a table weight, Adam with decoupled decay and a
# clamp, and a center kept as a state buffer that moves after each step.
CLIP = 2.0**-7   # the stand-in's clamp, exact in float32
STANDIN_REFERENCE = '''"""A stand-in algorithm: four views (two of 16x16, two of 8x8), a
per-pixel linear map with a position table, mean-pooled, a linear head; a
cross-entropy of the last three views' outputs against the softmax of the
first's less a center; AdamW with a clamp; the center moves to the mean
of the first view's outputs after each step."""

import torch

from . import augment
from .common import adam, lr_at

DIM, OUT = 8, 4
SIZES = ((16, 16), (16, 16), (8, 8), (8, 8))


def specs(cfg):
    return [("model.embed.weight", (DIM, 3), "linear"), ("model.pos", (1, 1, 1, DIM), "table"),
            ("model.head.weight", (OUT, DIM), "linear"), ("model.head.bias", (OUT,), "zero"),
            ("center.value", (1, OUT), "normal", "buffer")]


def trainable(names):
    return [n for n in names if n.startswith("model.")]


def views(generator, raw_u8, cfg):
    base = cfg["data"]["transforms"]["train"]
    return [augment.train_view(generator, raw_u8, {**base, "random_resized_crop": {
        **base["random_resized_crop"], "size": list(size)}}) for size in SIZES]


def init_state(weights, cfg):
    return {"center": weights["center.value"].clone()}


def tower(params, x, cast):
    h = torch.relu(cast(cast(x) @ cast(params["model.embed.weight"]).T) + params["model.pos"])
    h = h.mean(dim=(1, 2))
    return cast(cast(h) @ cast(params["model.head.weight"]).T) + params["model.head.bias"]


def loss(params, views, cfg, cast, state):
    outs = [tower(params, v, cast) for v in views]
    state["first"] = outs[0].detach()
    target = torch.softmax((outs[0].detach() - state["center"]) / 0.1, dim=-1)
    return sum(-(target * torch.log_softmax(o, dim=-1)).sum(-1).mean() for o in outs[1:]) / 3


def update(params, grads, opt_state, step, cfg, steps_per_epoch):
    opt = cfg["optimizer"]
    return adam(params, grads, opt_state, step, lr_at(step, cfg, steps_per_epoch),
                float(opt["weight_decay"]), decoupled=True, clip=float(cfg["gradient_clip"]),
                eps=float(opt["epsilon"]))


@torch.no_grad()
def after_update(params, step, cfg, steps_per_epoch, state):
    state["center"] = 0.9 * state["center"] + 0.1 * state["first"].mean(0, keepdim=True)
'''

STANDIN_COUNTS = '''"""FLOPs an image of the stand-in's step: four views' pixel maps and
heads, forward and backward."""


def flops_per_image(cfg, hw, batch):
    return 3 * 2 * (2 * 16 * 16 + 2 * 8 * 8) * 3 * 8 + 3 * 4 * 2 * 8 * 4
'''

STANDIN_RUN = '''
import json, sys
import torch
import perfbench
from perfbench import harness, inputs, reference
from perfbench.tests.tiny import TRAFFIC

torch.set_num_threads(2)
cell = harness.Cell("standin_small", root=harness.ROOT, traffic=TRAFFIC)
seed = 2**34 + 3
weights = inputs.weights(cell.specs, seed, "cpu")
images = inputs.images(cell.traffic, seed, "cpu")["train_images"]
out = {"package": perfbench.__file__, "buffers": sorted(cell.buffers),
       "flops": cell.flops_per_image, "steps_per_epoch": cell.steps_per_epoch, "runs": {}}
for name, cast, fault in [("float32", "float32", None), ("control", "fp8", None),
                          ("frozen", "float32", "frozen"), ("frozen_late", "float32", "frozen_late"),
                          ("half", "float32", "half"), ("grad2", "float32", "grad2")]:
    got = reference.run_steps(cell.cfg, weights, images, 5, inputs.streams(seed)["draws"],
                              cell.steps_per_epoch, cast=cast, fault=fault)
    grads = torch.cat([g.flatten() for g in got["first_grad"].values()]).abs()
    out["runs"][name] = {"losses": got["losses"], "params": sorted(got["params"]),
                         "first_grad": {n: g.tolist() for n, g in got["first_grad"].items()},
                         "final": {n: p.tolist() for n, p in got["params"].items()},
                         "grad_max": float(grads.max()), "at_clip": int((grads == cell.cfg["gradient_clip"]).sum())}
print(json.dumps(out))
'''


def test_a_new_algorithm_is_files_and_entries(tmp_path, bench):
    """The stand-in algorithm above, its counts, a configuration and two
    entries dropped into a copy: the harness takes the cell, the reference
    runs its steps (four views in two sizes, the table weight, the buffer
    held apart from the parameters, the clamp), the control and each fault
    change what it gives, and no file of the harness changed."""
    copy = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", copy, ignore=shutil.ignore_patterns("__pycache__"))
    added = {"reference/standin.py": STANDIN_REFERENCE, "counts/standin.py": STANDIN_COUNTS}
    cfg = json.loads((ROOT / "perfbench/configs/simclr_resnet18_cifar10.json").read_text())
    cfg.update(algo="standin", arch="standin", epochs=100, gradient_clip=CLIP,
               scheduler={"name": "cosine", "warmup_epochs": 0},
               optimizer={"name": "adamw", "lr": 0.01, "epsilon": 1e-6, "weight_decay": 0.04})
    cfg["data"]["batch_size"] = 8
    added["configs/standin_tiny.json"] = json.dumps(cfg)
    for rel, text in added.items():
        (copy / rel).write_text(text)
    new = dict(bench)
    new["configs"] = bench["configs"] + [
        {"name": "standin_tiny", "source": "a test's stand-in",
         "file": "perfbench/configs/standin_tiny.json", "reduced": [], "why": "a test's"}]
    new["workloads"] = bench["workloads"] + [
        {"name": "standin_small", "config": "standin_tiny", "traffic": "cifar10_shaped_epochs",
         "chips": 1, "why": "a test's cell"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))

    env = {**os.environ, "PYTHONPATH": str(tmp_path), "PYTHONDONTWRITEBYTECODE": "1",
           "OMP_NUM_THREADS": "2"}
    run = subprocess.run([sys.executable, "-c", STANDIN_RUN], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert Path(got["package"]).parent == copy
    assert got["buffers"] == ["center.value"] and got["flops"] > 0
    runs = got["runs"]
    sound = runs["float32"]
    assert sound["params"] == ["model.embed.weight", "model.head.bias", "model.head.weight",
                               "model.pos"]
    assert sound["grad_max"] == CLIP and sound["at_clip"] > 0   # the clamp took some
    for name in ("control", "frozen", "frozen_late", "half", "grad2"):
        assert runs[name] != sound, name
        assert runs[name]["final"] != sound["final"] or runs[name]["first_grad"] != sound[
            "first_grad"], name

    changed = filecmp.dircmp(ROOT / "perfbench", copy, ignore=["__pycache__"])

    def differing(d, at=""):
        out = [at + f for f in d.diff_files + d.left_only + d.funny_files]
        out += [at + f for f in d.right_only if at + f not in added]
        for sub, dd in d.subdirs.items():
            out += differing(dd, f"{at}{sub}/")
        return out

    assert differing(changed) == []
