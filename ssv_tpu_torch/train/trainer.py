"""The generic trainer (port of ssv_tpu/train/trainer.py, the slice's part).

Experiment init, the epoch loop and KNN validation every `eval_every`
epochs. An epoch is a Python loop of steps over a (steps, batch) index
matrix drawn on the device; augmentation, forward, backward and the
optimizer update all stay on the device, and the per-step losses are read
to the host once per epoch. Checkpoints, the final linear probe and
`train_safe` are not ported yet (ROADMAP slice A, item 9).
"""

from __future__ import annotations

import os
import time

import torch

from ..core.experiment import DEFAULT_SEED, initialize_experiment
from ..data.pipeline import DataPipeline
from ..evals.knn import compute_neighbor_accuracy
from ..utils.logging import get_wandb, progress_bar
from .base import DataInfo, TrainState
from .registry import build_algorithm

STEADY_AFTER = 5  # steps of an epoch left out of its steady-state img/s


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


class Trainer:
    def __init__(self, args: dict, device: torch.device | str | None = None):
        self.args = dict(args)
        self.device = torch.device(device) if device is not None else default_device()
        # float32 matmuls and convolutions stay float32 (the bf16 autocast
        # region is where the speed comes from); stated, not left to defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        algo_name, arch = args["algo"], args["arch"]
        output_root = os.path.join("outputs", algo_name, arch)
        config, self.output_dir, self.logger = initialize_experiment(
            self.args, output_root, self.device, seed=DEFAULT_SEED)
        cfg = self.config = config.raw()

        self.wandb = get_wandb()
        self.wandb.init(project=(cfg.get("wandb") or {}).get("project"),
                        output_dir=self.output_dir)

        self.pipeline = DataPipeline(cfg["data"], self.device)
        self.data_info = DataInfo(
            num_classes=self.pipeline.num_classes,
            n_train=self.pipeline.n_train,
            batch_size=self.pipeline.batch_size,
            steps_per_epoch=self.pipeline.steps_per_epoch,
        )
        self.algorithm = build_algorithm(algo_name, cfg, arch, self.data_info,
                                         self.device)
        self.epochs = int(cfg["epochs"])
        self.eval_every = int(cfg.get("eval_every", 10))

        # every random draw of the run comes from this device generator;
        # the weights from a host generator of the same seed
        self.generator = torch.Generator(device=self.device).manual_seed(DEFAULT_SEED)
        self.state: TrainState = self.algorithm.init_state(
            torch.Generator().manual_seed(DEFAULT_SEED))

        self._batch_fn = self.pipeline.make_batch_fn(self.algorithm.batch_kind)
        self._eval_t = self.pipeline.make_eval_transform()
        self.best_metric = 0.0
        self.start_epoch = 1
        self.epoch_stats: list[dict] = []

    # ------------------------------------------------------------------
    # feature extraction (the reference's build_features)
    # ------------------------------------------------------------------
    def features_for(self, state: TrainState, split: str = "train",
                     progress_desc: str | None = None):
        """Returns (fvecs, labels) as tensors on the device, with the
        algorithm's embed semantics."""
        images, labels = self.pipeline.arrays(split)
        chunks = []
        # a fixed stream, as the JAX trainer's PRNGKey(0), for any random op
        generator = torch.Generator(device=self.device).manual_seed(0)
        batches = list(self.pipeline.eval_batches(split))
        for i, (idx, count) in enumerate(batches):
            x = self._eval_t(generator, images[idx])
            chunks.append(self.algorithm.embed(state, x)[:count])
            if progress_desc:
                progress_bar(progress=(i + 1) / len(batches), desc=progress_desc)
        return torch.cat(chunks), labels

    def build_features(self, split: str = "train"):
        return self.features_for(self.state, split,
                                 progress_desc=f"Building {split} features")

    def knn_validate(self) -> float:
        fvecs, gt = self.features_for(self.state, "test")
        return compute_neighbor_accuracy(fvecs, gt, k=20)

    # ------------------------------------------------------------------
    def _run_epoch(self, state: TrainState, idx_mat: torch.Tensor):
        """All steps of one epoch. Returns (state, {metric: (steps,) host
        tensor}, steady-state img/s or None off CUDA)."""
        images, labels = self.pipeline.arrays("train")
        cuda = self.device.type == "cuda"
        collected: dict[str, list] = {}
        events = []
        for s in range(idx_mat.shape[0]):
            batch = self._batch_fn(images, labels, idx_mat[s], self.generator)
            state, metrics = self.algorithm.train_step(state, batch, self.generator)
            for k, v in metrics.items():
                collected.setdefault(k, []).append(v)
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
        metrics = {k: torch.stack(v).cpu() for k, v in collected.items()}
        steady = None
        if cuda and len(events) > STEADY_AFTER:
            events[-1].synchronize()
            ms = events[STEADY_AFTER - 1].elapsed_time(events[-1])
            steady = (len(events) - STEADY_AFTER) * idx_mat.shape[1] / (ms / 1e3)
        return state, metrics, steady

    def train(self) -> float:
        """Runs the epochs; returns the best KNN accuracy seen."""
        self.logger.print("Beginning training.", mode="info")
        state = self.algorithm.pre_train(self.state, self)
        for epoch in range(self.start_epoch, self.epochs + 1):
            state = self.algorithm.pre_epoch(state, self, epoch)
            idx_mat = self.pipeline.epoch_indices(self.generator)
            t0 = time.perf_counter()
            state, metrics, steady = self._run_epoch(state, idx_mat)
            state = self.algorithm.post_epoch(state, epoch)
            dt = time.perf_counter() - t0
            self.state = state
            self.start_epoch = epoch + 1
            means = {k: float(v.mean()) for k, v in metrics.items()}
            self.epoch_stats.append({
                "epoch": epoch, "steps": idx_mat.shape[0],
                "losses": metrics["loss"].tolist(), "seconds": dt,
                "steady_img_per_s": steady})

            ips = idx_mat.numel() / dt
            msg = (f"Epoch {epoch:4d}/{self.epochs:4d} "
                   + " ".join(f"[{k}] {v:.4f}" for k, v in means.items())
                   + f" [img/s] {ips:,.0f}")
            if steady is not None:
                msg += f" [steady img/s] {steady:,.0f}"
            self.logger.write(msg, mode="train")
            self.wandb.log({"Train loss": means.get("loss", 0.0),
                            "images_per_sec": ips, "Epoch": epoch,
                            **{k: v for k, v in means.items() if k != "loss"}})

            if epoch % self.eval_every == 0:
                knn_acc = self.knn_validate()
                self.logger.record(
                    f"Epoch {epoch:4d}/{self.epochs:4d} [accuracy] {knn_acc:.4f}",
                    mode="val")
                self.wandb.log({"KNN accuracy": knn_acc, "Epoch": epoch})
                self.best_metric = max(self.best_metric, knn_acc)

        self.state = state
        self.logger.print("Completed training.", mode="info")
        return self.best_metric
