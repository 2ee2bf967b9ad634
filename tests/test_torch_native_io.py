"""The port's native IO library (ssv_tpu_torch/csrc/ssv_io.cc, bound by
ssv_tpu_torch/data/native_io.py) against the JAX package's
(ssv_tpu/data/native_io.py over native/ssv_io.cc) and against its own NumPy
versions, bit for bit, on files written as tests/test_native_io.py writes
them (inputs from a numpy seed): CIFAR-10's 1 label byte, CIFAR-100's 2, a
file that ends in a partial row. The `.raw` cache written by either package
is read by the other, and `load_dataset` gives the JAX package's arrays on a
binary directory, a pickle directory and a cache. A failed build raises
with the compiler's message."""

import os
import pickle
import shutil

import numpy as np
import pytest

from ssv_tpu.data import datasets as J
from ssv_tpu.data import native_io as JIO
from ssv_tpu_torch.data import datasets as T
from ssv_tpu_torch.data import native_io as TIO
from ssv_tpu_torch.ops import build


def _rows(n, label_bytes, seed):
    """n CIFAR binary rows: label byte(s) (coarse first), then 3072 CHW."""
    r = np.random.RandomState(seed)
    labels = r.randint(0, 100 if label_bytes == 2 else 10, (n, label_bytes)).astype(np.uint8)
    images_chw = r.randint(0, 256, size=(n, 3, 32, 32), dtype=np.uint8)
    return labels[:, -1], images_chw, np.concatenate(
        [labels, images_chw.reshape(n, -1)], axis=1).tobytes()


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_library_builds():
    assert TIO.available()
    assert build.library_path("ssv_io").is_file()
    assert build.source("ssv_io").name == "ssv_io.cc"


@pytest.mark.parametrize("n", [1, 17, 300])
def test_chw_to_hwc_bit_identical(n):
    chw = np.random.RandomState(n).randint(0, 256, size=(n, 3, 32, 32), dtype=np.uint8)
    got = TIO.chw_to_hwc(chw)
    _same([got], [JIO.chw_to_hwc(chw)])
    _same([got], [TIO.chw_to_hwc_numpy(chw)])
    _same([got], [np.ascontiguousarray(chw.transpose(0, 2, 3, 1))])


@pytest.mark.parametrize("label_bytes,n,max_n,tail", [
    (1, 20, 10000, 0), (2, 20, 10000, 0), (1, 20, 7, 0), (1, 9, 10000, 1000)],
    ids=["cifar10", "cifar100", "max-n", "short-file"])
def test_read_cifar_binary_bit_identical(tmp_path, label_bytes, n, max_n, tail):
    """Labels (the fine label, the last label byte) and HWC images; a file
    ending in `tail` bytes of a partial row reads the whole rows only."""
    labels, images_chw, payload = _rows(n, label_bytes, seed=label_bytes)
    path = tmp_path / "batch.bin"
    path.write_bytes(payload + bytes(tail))
    got = TIO.read_cifar_binary(str(path), label_bytes, max_n)
    k = min(n, max_n)
    _same(got, [images_chw[:k].transpose(0, 2, 3, 1), labels[:k].astype(np.int32)])
    _same(got, JIO.read_cifar_binary(str(path), label_bytes, max_n))
    _same(got, TIO.read_cifar_binary_numpy(str(path), label_bytes, max_n))
    _same(got, T._read_cifar_binary(str(path), label_bytes, max_n))


def test_read_cifar_binary_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        TIO.read_cifar_binary(str(tmp_path / "nope.bin"), 1, 10)


def _split(n, seed, hw=(32, 32)):
    r = np.random.RandomState(seed)
    return (r.randint(0, 256, size=(n, *hw, 3), dtype=np.uint8),
            r.randint(0, 100, n).astype(np.int32))


@pytest.mark.parametrize("writer", ["port", "port-numpy", "jax"])
def test_raw_cache_interchangeable(tmp_path, writer):
    """A cache written by the port's library, its NumPy version or the JAX
    package's library: the same bytes, and every reader gives the arrays
    back."""
    images, labels = _split(13, 0, hw=(24, 20))
    path = str(tmp_path / "c.raw")
    write = {"port": TIO.write_raw_cache, "port-numpy": TIO.write_raw_cache_numpy,
             "jax": JIO.write_raw_cache}[writer]
    assert write(path, images, labels)
    ref = str(tmp_path / "ref.raw")
    TIO.write_raw_cache(ref, images, labels)
    assert open(path, "rb").read() == open(ref, "rb").read()
    for read in (TIO.read_raw_cache, TIO.read_raw_cache_numpy, JIO.read_raw_cache):
        _same(read(path), [images, labels])


@pytest.mark.parametrize("read", [TIO.read_raw_cache, TIO.read_raw_cache_numpy],
                         ids=["port", "port-numpy"])
def test_raw_cache_refuses_what_is_not_a_cache(tmp_path, read):
    """A missing file, another file, and a cache cut short read as None, as
    the JAX package's reader gives them."""
    images, labels = _split(5, 1)
    whole = str(tmp_path / "whole.raw")
    TIO.write_raw_cache(whole, images, labels)
    cut = tmp_path / "cut.raw"
    cut.write_bytes(open(whole, "rb").read()[:-7])
    other = tmp_path / "other.raw"
    other.write_bytes(b"not a cache at all, not at all")
    for p in (tmp_path / "missing.raw", cut, other):
        assert read(str(p)) is None
        assert JIO.read_raw_cache(str(p)) is None


def _binary_dir(root, name):
    """A cifar-10-batches-bin (5 train files of 10 rows, test 8) or a
    cifar-100-binary (train 30, test 6) directory under root."""
    if name == "cifar10":
        d = root / "cifar-10-batches-bin"
        files = [(f"data_batch_{i}.bin", 10, 1, i) for i in range(1, 6)]
        files.append(("test_batch.bin", 8, 1, 99))
    else:
        d = root / "cifar-100-binary"
        files = [("train.bin", 30, 2, 1), ("test.bin", 6, 2, 2)]
    os.makedirs(d)
    for fname, n, label_bytes, seed in files:
        (d / fname).write_bytes(_rows(n, label_bytes, seed)[2])
    return d


def _pickle_dir(root):
    d = root / "cifar-10-batches-py"
    os.makedirs(d)
    r = np.random.RandomState(0)
    for i in range(1, 6):
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump({"data": r.randint(0, 256, size=(10, 3072), dtype=np.uint8),
                         "labels": r.randint(0, 10, 10).tolist()}, f)
    with open(d / "test_batch", "wb") as f:
        pickle.dump({"data": r.randint(0, 256, size=(6, 3072), dtype=np.uint8),
                     "labels": r.randint(0, 10, 6).tolist()}, f)
    return d


def _assert_datasets_equal(a, b):
    assert (a.name, a.num_classes, a.synthetic) == (b.name, b.num_classes, b.synthetic)
    for split in ("train", "test"):
        x, y = getattr(a, split), getattr(b, split)
        _same([x.images, x.labels], [y.images, y.labels])


@pytest.mark.parametrize("layout", ["cifar10-binary", "cifar100-binary", "cifar10-pickle"])
def test_load_dataset_and_its_cache_match_jax(tmp_path, layout):
    """Each package's first load on its own copy of the directory: the same
    arrays, and the same cache files written beside it, byte for byte. Then
    each package reads the other's cache with the source directory gone."""
    name = layout.split("-")[0]
    roots = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        src = _pickle_dir(root) if layout.endswith("pickle") else _binary_dir(root, name)
        roots[pkg] = (root, src)
    jds = J.load_dataset(name, str(roots["jax"][0]), allow_synthetic=False)
    tds = T.load_dataset(name, str(roots["port"][0]), allow_synthetic=False)
    _assert_datasets_equal(tds, jds)
    for split in ("train", "test"):
        files = [root / f"{name}_{split}.raw" for root, _ in roots.values()]
        assert files[0].read_bytes() == files[1].read_bytes()
    assert not [p for p in os.listdir(roots["port"][0]) if p.endswith(".tmp")]
    for root, src in roots.values():
        shutil.rmtree(src)
    # the port reads the cache JAX wrote, and JAX the port's
    _assert_datasets_equal(T.load_dataset(name, str(roots["jax"][0]), allow_synthetic=False),
                           jds)
    _assert_datasets_equal(J.load_dataset(name, str(roots["port"][0]), allow_synthetic=False),
                           jds)


def test_synthetic_sets_write_no_cache(tmp_path):
    ds = T.load_dataset("cifar10", str(tmp_path), synthetic_sizes=(16, 8))
    assert ds.synthetic
    assert os.listdir(tmp_path) == []


def test_cache_write_error_is_ignored(tmp_path, monkeypatch):
    """An OSError while writing the cache leaves the load as it was."""
    _pickle_dir(tmp_path)

    def refuse(*args):
        raise OSError("read-only file system")

    monkeypatch.setattr(TIO, "write_raw_cache", refuse)
    ds = T.load_dataset("cifar10", str(tmp_path), allow_synthetic=False)
    assert ds.train.images.shape == (50, 32, 32, 3)
    assert not [p for p in os.listdir(tmp_path) if p.endswith((".raw", ".tmp"))]


def test_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    """A source g++ refuses: `build` raises with g++'s message (the JAX
    module would fall back to NumPy), and nothing is left in the build
    directory."""
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "ssv_io.cc").write_text('extern "C" int f() { return undeclared; }\n')
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*undeclared"):
        build.build("ssv_io")
    assert list((tmp_path / "build").iterdir()) == []
