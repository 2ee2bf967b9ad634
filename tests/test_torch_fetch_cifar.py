"""The port's CIFAR staging tool (`python -m ssv_tpu_torch.tools.fetch_cifar`,
the counterpart of scripts/fetch_cifar.py): a seeded tarball or extracted
directory in the published pickle layout is staged in a process where JAX
and the JAX package cannot be imported, the `.raw` cache is written, and
the port's load of the staged root equals the JAX package's bit for bit.
No test reaches the network."""

import os
import pickle
import shutil
import subprocess
import sys
import tarfile
import urllib.request

import numpy as np
import pytest

from ssv_tpu.data import datasets as J
from ssv_tpu_torch.data import datasets as T
from ssv_tpu_torch.tools import fetch_cifar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs the tool as `python -m` would, with JAX, its libraries and the JAX
# package unimportable (the tool's cache warm-up imports lazily, so an
# import-time check would not see it)
GUARD = """
import importlib.abc, runpy, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "ssv_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"{name} cannot be imported here", name=name)
        return None
sys.meta_path.insert(0, Block())
sys.argv = ["fetch_cifar"] + sys.argv[1:]
try:
    runpy.run_module("ssv_tpu_torch.tools.fetch_cifar", run_name="__main__")
finally:
    bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not bad, bad
"""

SIZES = {"cifar10": (5 * 24, 40), "cifar100": (96, 40)}


def write_pickle_dir(parent, dataset, seed=0):
    """The published pickle layout from a seed: cifar10's five data batches
    and test_batch with `labels`, cifar100's train and test with
    `fine_labels` and `coarse_labels`."""
    rng = np.random.RandomState(seed)
    n_train, n_test = SIZES[dataset]
    d = os.path.join(parent, fetch_cifar.EXTRACTED_DIR[dataset])
    os.makedirs(d, exist_ok=True)

    def write(name, n):
        data = rng.randint(0, 256, size=(n, 3072), dtype=np.uint8)
        if dataset == "cifar10":
            entry = {"data": data, "labels": rng.randint(0, 10, n).tolist()}
        else:
            entry = {"data": data, "fine_labels": rng.randint(0, 100, n).tolist(),
                     "coarse_labels": rng.randint(0, 20, n).tolist()}
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(entry, f)

    if dataset == "cifar10":
        for i in range(1, 6):
            write(f"data_batch_{i}", n_train // 5)
        write("test_batch", n_test)
    else:
        write("train", n_train)
        write("test", n_test)
    return d


def write_tarball(tmp_path, dataset):
    src = write_pickle_dir(str(tmp_path / "src"), dataset)
    tar = tmp_path / f"{dataset}-python.tar.gz"
    with tarfile.open(tar, "w:gz") as tf:
        tf.add(src, arcname=fetch_cifar.EXTRACTED_DIR[dataset])
    return str(tar), src


def run_tool(*args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-c", GUARD, *args], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=180)


def _assert_same(a, b):
    assert a.num_classes == b.num_classes
    assert not a.synthetic and not b.synthetic
    for split in ("train", "test"):
        x, y = getattr(a, split), getattr(b, split)
        assert x.images.dtype == y.images.dtype == np.uint8
        assert x.labels.dtype == y.labels.dtype
        np.testing.assert_array_equal(x.images, y.images)
        np.testing.assert_array_equal(x.labels, y.labels)


@pytest.mark.parametrize("source", ["tarball", "directory"])
@pytest.mark.parametrize("dataset", ["cifar10", "cifar100"])
def test_stage_without_jax_then_load_matches_jax(dataset, source, tmp_path):
    tar, src = write_tarball(tmp_path, dataset)
    root = tmp_path / "data"
    proc = run_tool("--dataset", dataset, "--root", str(root),
                    "--from", tar if source == "tarball" else src, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    # the fake tarball's md5 is not the published one: warned, staged anyway
    assert ("md5 mismatch" in proc.stdout) == (source == "tarball")
    assert f"staged {dataset}" in proc.stdout
    for split in ("train", "test"):
        assert (root / f"{dataset}_{split}.raw").is_file()
    assert (root / fetch_cifar.EXTRACTED_DIR[dataset] /
            ("data_batch_1" if dataset == "cifar10" else "train")).is_file()

    # JAX's reader on a root that holds only the pickles, against the port's
    # load of the staged root (its cache) and of the pickles themselves
    jax_root = tmp_path / "jax_root"
    shutil.copytree(src, jax_root / fetch_cifar.EXTRACTED_DIR[dataset])
    want = J.load_dataset(dataset, str(jax_root), allow_synthetic=False)
    n_train, n_test = SIZES[dataset]
    assert want.train.images.shape == (n_train, 32, 32, 3)
    assert want.test.images.shape == (n_test, 32, 32, 3)
    assert want.num_classes == (10 if dataset == "cifar10" else 100)
    cached = T.load_dataset(dataset, str(root), allow_synthetic=False)
    _assert_same(cached, want)
    for split in ("train", "test"):
        assert ((root / f"{dataset}_{split}.raw").read_bytes()
                == (jax_root / f"{dataset}_{split}.raw").read_bytes())
    shutil.rmtree(jax_root / fetch_cifar.EXTRACTED_DIR[dataset])
    _assert_same(T.load_dataset(dataset, str(root), allow_synthetic=False),
                 J.load_dataset(dataset, str(jax_root), allow_synthetic=False))


@pytest.mark.parametrize("dataset", ["cifar10", "cifar100"])
def test_no_network_prints_instructions_and_exits_2(dataset, tmp_path, monkeypatch,
                                                    capsys):
    tried = []

    def refuse(url, *args, **kwargs):
        tried.append(url)
        raise OSError("no route to host")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    rc = fetch_cifar.main(["--dataset", dataset, "--root", str(tmp_path / "data")])
    out = capsys.readouterr().out
    assert rc == 2
    assert tried == fetch_cifar.URLS[dataset]
    assert "python -m ssv_tpu_torch.tools.fetch_cifar" in out
    assert fetch_cifar.MD5[dataset] in out
    assert "scripts/fetch_cifar.py" not in out
    assert not (tmp_path / "data" / f"{dataset}_train.raw").exists()


def test_keeps_the_scripts_constants():
    """URLs, md5s and directory names as scripts/fetch_cifar.py has them (read
    by path: the script is not a module of either package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fetch_cifar_script", os.path.join(REPO, "scripts", "fetch_cifar.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert fetch_cifar.URLS == script.URLS
    assert fetch_cifar.MD5 == script.MD5
    assert fetch_cifar.EXTRACTED_DIR == script.EXTRACTED_DIR


def test_unsafe_member_is_refused(tmp_path):
    """The `data` filter: a member that leaves the root is not extracted."""
    evil = tmp_path / "evil.tar.gz"
    payload = tmp_path / "payload"
    payload.write_bytes(b"x")
    with tarfile.open(evil, "w:gz") as tf:
        tf.add(payload, arcname="../outside")
    with pytest.raises(tarfile.FilterError):
        fetch_cifar.stage_tarball(str(evil), "cifar10", str(tmp_path / "root"))
    assert not (tmp_path / "outside").exists()
