"""The on-device input pipeline (port of ssv_tpu/data/pipeline.py).

  * the raw uint8 dataset is copied to the device ONCE (CIFAR-10 train is
    150 MB) and stays there;
  * a batch is a vector of indices on the device: the step gathers the uint8
    rows and runs the whole augmentation pipeline on the device, so nothing
    but the generator's state crosses from the host per step;
  * epoch shuffling is `torch.randperm` on the device.

Batch dicts keep the JAX package's keys: `double` ->
{index, img, aug_1, aug_2, label}.
"""

from __future__ import annotations

from typing import Callable

import torch

from .augment import build_batch_transform, build_transform
from .datasets import Dataset, load_dataset


class DataPipeline:
    def __init__(self, data_cfg: dict, device: torch.device,
                 synthetic_sizes: tuple[int, int] | None = None):
        cfg = dict(data_cfg)
        self.device = torch.device(device)
        self.batch_size = int(cfg["batch_size"])
        self.dataset: Dataset = load_dataset(
            cfg["dataset_name"], cfg.get("root", "data"),
            synthetic_sizes=synthetic_sizes)
        self.num_classes = self.dataset.num_classes
        self.transforms_cfg = cfg.get("transforms")

        def put(a, dtype=None):
            t = torch.from_numpy(a)
            return t.to(self.device, dtype=dtype or t.dtype)

        self._train_images = put(self.dataset.train.images)
        self._train_labels = put(self.dataset.train.labels, torch.int64)
        self._test_images = put(self.dataset.test.images)
        self._test_labels = put(self.dataset.test.labels, torch.int64)

    # ------------------------------------------------------------------
    @property
    def n_train(self) -> int:
        return int(self._train_images.shape[0])

    @property
    def n_test(self) -> int:
        return int(self._test_images.shape[0])

    @property
    def steps_per_epoch(self) -> int:
        # a fixed batch shape: the final partial batch is dropped
        return self.n_train // self.batch_size

    def arrays(self, split: str = "train"):
        if split == "train":
            return self._train_images, self._train_labels
        return self._test_images, self._test_labels

    def epoch_indices(self, generator: torch.Generator) -> torch.Tensor:
        """(steps, batch) random permutation of train indices, on the device."""
        steps = self.steps_per_epoch
        perm = torch.randperm(self.n_train, generator=generator, device=self.device)
        return perm[: steps * self.batch_size].reshape(steps, self.batch_size)

    # ------------------------------------------------------------------
    def make_batch_fn(self, kind: str) -> Callable:
        """Returns fn(images_u8, labels, idx, generator) -> batch dict."""
        if kind == "double":
            t = dict(self.transforms_cfg)
            train_t = build_batch_transform(t["train"])
            test_t = build_transform(t["test"])

            def fn(images, labels, idx, generator):
                raw = images[idx]
                return {
                    "index": idx,
                    "img": test_t(generator, raw),
                    "aug_1": train_t(generator, raw),
                    "aug_2": train_t(generator, raw),
                    "label": labels[idx],
                }
            return fn

        if kind in ("pseudolabel", "multicrop"):
            raise NotImplementedError(
                f"batch kind {kind!r} is not yet ported to ssv_tpu_torch "
                f"(ROADMAP slice B)")
        raise ValueError(f"Unknown batch kind {kind!r}")

    def make_eval_transform(self) -> Callable:
        """The deterministic test-time transform (center crop + normalize)."""
        return build_transform(dict(self.transforms_cfg)["test"])

    def eval_batches(self, split: str = "test"):
        """Iterator of (idx on the device, count) covering a split, padded to
        a full final batch (pad rows repeat index 0; callers keep `count`)."""
        bs = self.batch_size
        n = self.n_train if split == "train" else self.n_test
        idx = torch.arange(n, device=self.device)
        n_pad = (-n) % bs
        if n_pad:
            idx = torch.cat([idx, torch.zeros(n_pad, dtype=idx.dtype, device=self.device)])
        for s in range(0, len(idx), bs):
            yield idx[s:s + bs], min(bs, n - s)
