"""The port's NumPy copies of the dataset readers, synthetic sets and config
view are bit-identical to the JAX package's, and its pipeline batches."""

import numpy as np
import pytest
import torch
import yaml

import helpers
from ssv_tpu.core import config as jax_config
from ssv_tpu.data import datasets as J
from ssv_tpu_torch.core import config as torch_config
from ssv_tpu_torch.data import datasets as T
from ssv_tpu_torch.data.pipeline import DataPipeline
from torch_helpers import stage_fake_cifar

torch.set_num_threads(2)


def _assert_same(a, b):
    assert a.name == b.name and a.num_classes == b.num_classes
    for split in ("train", "test"):
        x, y = getattr(a, split), getattr(b, split)
        assert x.images.dtype == y.images.dtype == np.uint8
        np.testing.assert_array_equal(x.images, y.images)
        np.testing.assert_array_equal(x.labels, y.labels)


@pytest.mark.parametrize("name", ["cifar10", "synth100", "shapes100"])
def test_synthetic_sets_bit_identical(name):
    if name == "cifar10":
        a, b = (m.make_synthetic("cifar10", 10, 64, 32) for m in (J, T))
    else:
        a = J.load_dataset(name, "", synthetic_sizes=(64, 32))
        b = T.load_dataset(name, "", synthetic_sizes=(64, 32))
    _assert_same(a, b)


def test_cifar_pickle_reader_bit_identical(tmp_path):
    stage_fake_cifar(str(tmp_path))
    _assert_same(J.load_dataset("cifar10", str(tmp_path), allow_synthetic=False),
                 T.load_dataset("cifar10", str(tmp_path), allow_synthetic=False))


def test_cifar_binary_reader_bit_identical(tmp_path):
    from ssv_tpu.data import native_io

    rng = np.random.RandomState(0)
    path = tmp_path / "batch.bin"
    rows = rng.randint(0, 256, size=(20, 1 + 3072)).astype(np.uint8)
    rows[:, 0] %= 10
    rows.tofile(path)
    want = native_io.read_cifar_binary(str(path), 1, 10000)
    got = T._read_cifar_binary(str(path), 1, 10000)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_config_view_matches(tmp_path):
    path = tmp_path / "c.yaml"
    cfg = helpers.mini_config("simclr")
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    a, b = jax_config.load_config(str(path)), torch_config.load_config(str(path))
    assert a.raw() == b.raw() == cfg
    assert list(a.data.transforms.train) == list(b.data.transforms.train)
    over = {"data": {"batch_size": 7}, "epochs": 3}
    assert jax_config._merge(cfg, over) == torch_config._merge(cfg, over)
    assert b.updated(over).data.batch_size == 7


def test_pipeline_indices_and_eval_padding():
    cfg = helpers.mini_config("simclr", batch_size=16)["data"]
    p = DataPipeline(cfg, "cpu", synthetic_sizes=(70, 37))
    assert p.steps_per_epoch == 4
    idx = p.epoch_indices(torch.Generator().manual_seed(0))
    assert idx.shape == (4, 16)
    assert len(set(idx.flatten().tolist())) == 64   # drop-last, no repeats
    batches = list(p.eval_batches("test"))
    assert [c for _, c in batches] == [16, 16, 5]
    assert all(i.shape == (16,) for i, _ in batches)
    assert batches[-1][0][5:].eq(0).all()            # padding repeats index 0
    fn = p.make_batch_fn("double")
    images, labels = p.arrays("train")
    batch = fn(images, labels, idx[0], torch.Generator().manual_seed(1))
    assert set(batch) == {"index", "img", "aug_1", "aug_2", "label"}
    for k in ("img", "aug_1", "aug_2"):
        assert batch[k].shape == (16, 32, 32, 3) and batch[k].dtype == torch.float32
    assert not torch.equal(batch["aug_1"], batch["aug_2"])
    with pytest.raises(NotImplementedError, match="slice B"):
        p.make_batch_fn("multicrop")
