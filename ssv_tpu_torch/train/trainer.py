"""The generic trainer (port of ssv_tpu/train/trainer.py).

Experiment init, the epoch loop, KNN validation every `eval_every` epochs
with full-state checkpoints (`best_model` when KNN improves, `latest` at
every eval), and a final linear probe whose accuracy `train()` returns.
An epoch runs the steps of a (steps, batch) index matrix drawn on the
device; augmentation, forward, backward, the optimizer update and the
algorithm's state updates all stay on the device, each step writes its
metrics into a (steps,) buffer on the device, and the host reads them once
per epoch. How the steps run is `epoch_mode` (`_epoch_mode` states the
rule): "graph", the JAX package's default (`jit_epoch` unset or true: the
epoch as one program), runs the step captured once as a CUDA graph and
replayed for every step (`train/graph.py`); "step", JAX's debugging mode
(`jit_epoch: false`), the CPU and a run across ranks, runs the same step
eagerly. Both give the same results from the same state and draws.
`train_safe()` flushes `latest` on an interrupt or error, and
`args["load"]` resumes from a run's directory. With `SSV_TPU_PROFILE_DIR`
set, `train()` writes a `torch.profiler` trace of one epoch there.

Under a process group (`parallel/`, started by `python -m
ssv_tpu_torch.main` under torchrun) every rank builds the same state,
rank 0's epoch index matrix is broadcast, and each rank trains on its
slice of every row with draws from its own generator (rank 0's is seeded
as a run without a group seeds it). Each rank embeds its slice of every
eval batch and the features are gathered, so KNN, the probe and the
algorithms' passes over a split see the whole split on every rank. Only
rank 0 writes checkpoints, logs and the epoch records.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

from ..core.config import _merge
from ..core.experiment import DEFAULT_SEED, initialize_experiment
from ..data.pipeline import DataPipeline
from ..evals.knn import compute_neighbor_accuracy
from ..evals.linear import linear_evaluation
from ..ops.photometric import fused_photometric
from ..parallel import batch_slice, pgather, rank, replicate, world_size
from ..parallel.mesh import barrier, broadcast_, data_rank
from ..utils.logging import get_wandb, progress_bar
from .base import DataInfo, TrainState
from .checkpoint import restore_state, save_state
from .graph import StepGraph
from .registry import build_algorithm

STEADY_AFTER = 5  # steps of an epoch left out of its steady-state img/s


def default_device(device: torch.device | str | None = None) -> torch.device:
    """The run's device: `device` when given, else CUDA. The CPU runs only
    when asked for; asking for CUDA without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; to train on the CPU, pass "
                           "--device cpu (or Trainer(..., device='cpu'))")
    return device


class Trainer:
    def __init__(self, args: dict, overrides: dict | None = None,
                 allow_synthetic: bool = True,
                 synthetic_sizes: tuple[int, int] | None = None,
                 make_dirs: bool = True, seed: int = DEFAULT_SEED,
                 device: torch.device | str | None = None, dataset=None):
        """The JAX Trainer's arguments, with its meanings: `overrides` is
        merged into the loaded config (`core.config._merge`);
        `allow_synthetic=False` raises where the config's dataset is not on
        disk, else `synthetic_sizes` (train, test) sizes the synthetic
        stand-in; `make_dirs=False` creates no output directory and writes
        no file there; `seed` seeds the host RNGs, the weights' host
        generator and rank r's device generator (`seed + r`). The JAX
        Trainer's `use_mesh` has no counterpart: the ranks come from
        torchrun (`parallel/`). `device` is the port's own: CUDA unless the
        CPU is asked for; so is `dataset`, a `data.datasets.Dataset` trained
        on in place of the config's (`ssv_tpu_torch.bench`'s images)."""
        self.device = default_device(device)
        self.args = dict(args)
        self.make_dirs = make_dirs
        # float32 matmuls and convolutions stay float32 (the bf16 autocast
        # region is where the speed comes from); stated, not left to defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        algo_name, arch = args["algo"], args["arch"]
        output_root = os.path.join("outputs", algo_name, arch)
        config, self.output_dir, self.logger = initialize_experiment(
            self.args, output_root, self.device, seed=seed, make_dirs=make_dirs)
        cfg = config.raw()
        if overrides:
            cfg = _merge(cfg, overrides)
        self.config = cfg

        self.wandb = get_wandb()
        self.wandb.init(project=(cfg.get("wandb") or {}).get("project"),
                        output_dir=self.output_dir if make_dirs else None)

        self.pipeline = DataPipeline(cfg["data"], self.device, allow_synthetic=allow_synthetic,
                                     synthetic_sizes=synthetic_sizes, dataset=dataset)
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

        # every random draw of the run comes from this device generator (one
        # a data rank, data rank 0's of the run's seed: the model ranks of a
        # row draw the same augmentations); the weights from a host
        # generator of the seed, the same on every rank, and rank 0's copy
        # is put on every rank
        self.generator = torch.Generator(device=self.device).manual_seed(seed + data_rank())
        self.state: TrainState = self.algorithm.init_state(
            torch.Generator().manual_seed(seed))
        for module in (self.state.model, *self.state.extra.values()):
            replicate(module)

        self._batch_fn = self.pipeline.make_batch_fn(self.algorithm.batch_kind)
        self._eval_t = self.pipeline.make_eval_transform()
        self.best_metric = 0.0
        self.start_epoch = 1
        self.epoch_stats: list[dict] = []
        self.linear_eval_stats: dict | None = None
        self._tracing = False   # inside `_trace`: each step is a profiler span

        self.epoch_mode, self.epoch_mode_reason = self._epoch_mode()
        # the epoch's inputs and outputs on the device, at fixed addresses (a
        # captured step reads and writes them): the index matrix, the
        # position of the step in it, one (steps,) buffer a metric
        self._epoch_idx: torch.Tensor | None = None
        self._pos = torch.zeros((), dtype=torch.int64, device=self.device)
        self._metric_bufs: dict[str, torch.Tensor] = {}
        self.graph: StepGraph | None = None

        if self.args.get("load"):
            self.load_checkpoint(self.args["load"])

    # ------------------------------------------------------------------
    # feature extraction (the reference's build_features)
    # ------------------------------------------------------------------
    def _stream(self, state: TrainState, fn, split: str):
        """Yields (fn(state, images), idx, count) over `split` in order, in
        batches of the train batch (the last padded; `count` real rows),
        the images through the eval transform with a fixed generator of
        seed 0, as the JAX trainer's PRNGKey(0), for any random op. What
        `fn` returns stays on the device. Across ranks every rank transforms
        the whole batch (the same draws as one process), embeds its slice,
        and the slices are gathered: every rank yields the whole batch."""
        images, _ = self.pipeline.arrays(split)
        generator = torch.Generator(device=self.device).manual_seed(0)
        for idx, count in self.pipeline.eval_batches(split):
            out = fn(state, batch_slice(self._eval_t(generator, images[idx])))
            out = tuple(map(pgather, out)) if isinstance(out, tuple) else pgather(out)
            yield out, idx, count

    def stream_train(self, state: TrainState, fn):
        """`_stream` over the train split (SeLA's self-labelling)."""
        return self._stream(state, fn, "train")

    def map_train(self, state: TrainState, fn):
        """fn(state, images) -> a tuple of tensors, over the train split in
        order; returns each output concatenated over the split, on the
        device (DeepCluster's features and predictions)."""
        chunks = [[o[:count] for o in out]
                  for out, _, count in self._stream(state, fn, "train")]
        return tuple(torch.cat(parts) for parts in zip(*chunks))

    def features_for(self, state: TrainState, split: str = "train",
                     feature_fn=None, progress_desc: str | None = None):
        """Returns (fvecs, labels) as tensors on the device, with the
        algorithm's embed semantics, or `feature_fn(state, images)`'s."""
        _, labels = self.pipeline.arrays(split)
        n = labels.shape[0]
        n_batches = -(-n // self.pipeline.batch_size)
        chunks = []
        fn = feature_fn or self.algorithm.embed
        for i, (z, _, count) in enumerate(self._stream(state, fn, split)):
            chunks.append(z[:count])
            if progress_desc:
                progress_bar(progress=(i + 1) / n_batches, desc=progress_desc)
        return torch.cat(chunks), labels

    def build_features(self, split: str = "train"):
        return self.features_for(self.state, split,
                                 progress_desc=f"Building {split} features")

    def knn_validate(self) -> float:
        fvecs, gt = self.features_for(self.state, "test")
        return compute_neighbor_accuracy(fvecs, gt, k=20)

    def perform_linear_eval(self) -> float:
        t0 = time.perf_counter()
        train_vecs, train_gt = self.features_for(self.state, "train")
        test_vecs, test_gt = self.features_for(self.state, "test")
        acc = linear_evaluation(
            config=self.config.get("linear_eval", {}),
            train_data={"fvecs": train_vecs, "labels": train_gt},
            test_data={"fvecs": test_vecs, "labels": test_gt},
            num_classes=self.pipeline.num_classes)
        self.linear_eval_stats = {"accuracy": acc, "seconds": time.perf_counter() - t0}
        self.logger.write(f"Test linear eval accuracy: {acc:.4f}", mode="info")
        return acc

    # ------------------------------------------------------------------
    # checkpoints: <output_dir>/<name> and <output_dir>/<name>.meta.json
    # ------------------------------------------------------------------
    def save_checkpoint(self, name: str = "best_model", epoch: int | None = None):
        """Every rank takes part (the generators are gathered); rank 0
        writes, and the ranks wait for it."""
        save_state(os.path.join(self.output_dir, name), self.state, self.generator)
        if rank() == 0:
            meta = {"best_metric": self.best_metric,
                    "start_epoch": (epoch + 1) if epoch is not None else self.start_epoch}
            with open(os.path.join(self.output_dir, f"{name}.meta.json"), "w") as f:
                json.dump(meta, f)
        barrier()

    def _epoch_mode(self) -> tuple[str, str]:
        """("graph" or "step", why). Graph, the JAX package's default
        whole-epoch program, where `jit_epoch` is unset or true on a CUDA
        device in one process; step where `jit_epoch` is false (JAX's
        debugging mode), on the CPU (no CUDA graphs there), and across
        ranks (the step's collectives are not captured)."""
        if not self.config.get("jit_epoch", True):
            return "step", "jit_epoch: false"
        if self.device.type != "cuda":
            return "step", f"{self.device.type}: no CUDA graphs"
        if world_size() > 1:
            return "step", f"{world_size()} ranks: collectives are not captured"
        return "graph", "jit_epoch: true, one CUDA process"

    def load_checkpoint(self, ckpt_dir: str, name: str | None = None):
        """Restores the full state from `ckpt_dir`: `name` if given, else
        for `train` the rolling `latest` first (exact resume), then
        `best_model`; for the inference tasks `best_model` first (the
        reference's only checkpoint), then `latest`. `train` also restores
        each rank's generator, so it resumes only at the world size that
        saved; the inference tasks draw nothing from them and load at any."""
        train = self.args.get("task") == "train"
        if name:
            candidates = [name]
        elif train:
            candidates = ["latest", "best_model"]
        else:
            candidates = ["best_model", "latest"]
        for cand in candidates:
            path = os.path.join(ckpt_dir, cand)
            if os.path.exists(path):
                # the optimizer's loaded state replaces the tensors a
                # captured step holds: drop the graph, capture anew
                self.graph = None
                restore_state(path, self.state, self.generator if train else None)
                meta_path = os.path.join(ckpt_dir, f"{cand}.meta.json")
                if os.path.exists(meta_path):
                    with open(meta_path) as f:
                        meta = json.load(f)
                    self.best_metric = meta.get("best_metric", 0.0)
                    self.start_epoch = meta.get("start_epoch", 1)
                self.logger.print(f"Loaded checkpoint from {path}", mode="info")
                return
        raise FileNotFoundError(f"No checkpoint under {ckpt_dir} ({candidates})")

    # ------------------------------------------------------------------
    def _train_step(self, state: TrainState) -> None:
        """One train step, reading nothing on the host: the step's index row
        at the epoch position, its batch, the algorithm's step, its metrics
        written at the position, the position advanced. The graph captures
        exactly this."""
        images, labels = self.pipeline.arrays("train")
        idx = torch.index_select(self._epoch_idx, 0, self._pos.reshape(1))[0]
        batch = self._batch_fn(images, labels, batch_slice(idx), self.generator)
        _, metrics = self.algorithm.train_step(state, batch, self.generator)
        for k, v in metrics.items():
            if k not in self._metric_bufs:
                self._metric_bufs[k] = torch.empty(self._epoch_idx.shape[0], dtype=v.dtype,
                                                   device=self.device)
            self._metric_bufs[k].index_copy_(0, self._pos.reshape(1), v.reshape(1))
        self._pos.add_(1)

    def begin_epoch(self, idx_mat: torch.Tensor) -> None:
        """Puts the epoch's index matrix where the step reads it, at the
        first step."""
        if self._epoch_idx is None or self._epoch_idx.shape != idx_mat.shape:
            self.graph = None
            self._epoch_idx = torch.empty_like(idx_mat)
            self._metric_bufs = {}
        self._epoch_idx.copy_(idx_mat)
        self._pos.zero_()

    def step(self, state: TrainState) -> None:
        """The next step of the epoch in the trainer's mode: eager, or a
        replay of the captured step (the first steps warm up and capture
        it)."""
        if state.scheduler.reserve(state.step):
            # steps past the run's end (a profile after training) refilled
            # the schedule tables: the captured step reads the old ones
            self.graph = None
        if self.epoch_mode == "step":
            self._train_step(state)
            return
        if self.graph is None:
            self.graph = StepGraph()
        self.graph.step(self, state)

    def _run_epoch(self, state: TrainState, idx_mat: torch.Tensor):
        """All steps of one epoch. Returns (state, {metric: (steps,) host
        tensor}, steady-state img/s or None off CUDA). Under `_trace` each
        step is a span `step <s>`."""
        cuda = self.device.type == "cuda"
        events = []
        self.begin_epoch(idx_mat)
        for s in range(idx_mat.shape[0]):
            with (torch.profiler.record_function(f"step {s}") if self._tracing
                  else contextlib.nullcontext()):
                self.step(state)
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
        metrics = {k: v.cpu() for k, v in self._metric_bufs.items()}
        steady = None
        if cuda and len(events) > STEADY_AFTER:
            events[-1].synchronize()
            ms = events[STEADY_AFTER - 1].elapsed_time(events[-1])
            steady = (len(events) - STEADY_AFTER) * idx_mat.shape[1] / (ms / 1e3)
        return state, metrics, steady

    def photometric_launches(self) -> int:
        """The photometric kernel's launches so far: the wrapper's count,
        and those the graph's replays made (`train/graph.py`)."""
        return fused_photometric.launches + StepGraph.replayed_launches

    def epoch_indices(self) -> torch.Tensor:
        """The epoch's (steps, batch) index matrix: rank 0's draw, on every
        rank."""
        idx_mat = self.pipeline.epoch_indices(self.generator)
        broadcast_([idx_mat])
        return idx_mat

    def _record(self, stats: dict) -> None:
        """Appends an epoch's record to `<output_dir>/epoch_stats.jsonl`
        (rank 0)."""
        if rank() == 0 and self.make_dirs:
            with open(os.path.join(self.output_dir, "epoch_stats.jsonl"), "a") as f:
                f.write(json.dumps(stats) + "\n")

    @contextlib.contextmanager
    def _trace(self, profile_dir: str, epoch: int):
        """A `torch.profiler` of the CPU (and CUDA) activities over the
        block, inside a span `epoch <epoch>`; at the end (the device
        synchronized) its Chrome trace JSON goes to
        `<profile_dir>/epoch<epoch>.rank<r>.json`."""
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as profiler:
            with record_function(f"epoch {epoch}"):
                self._tracing = True
                try:
                    yield
                finally:
                    self._tracing = False
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"epoch{epoch}.rank{rank()}.json")
        profiler.export_chrome_trace(path)
        self.logger.print(f"Profiler trace written to {path}", mode="info")

    def train(self) -> float:
        """Runs the epochs from `start_epoch`; returns the final linear
        probe's accuracy."""
        self.logger.print(f"Beginning training. Epoch mode: {self.epoch_mode} "
                          f"({self.epoch_mode_reason}).", mode="info")
        if self.start_epoch == 1:
            state = self.algorithm.pre_train(self.state, self)
        else:
            # resumed: the algorithm's state came from the checkpoint
            state = self.state
        # SSV_TPU_PROFILE_DIR: a trace of this run's second epoch, the first
        # after cuDNN's algorithm choice and the allocator's growth; pinned
        # now, since start_epoch advances in the loop
        profile_dir = os.environ.get("SSV_TPU_PROFILE_DIR")
        profile_epoch = self.start_epoch + 1
        for epoch in range(self.start_epoch, self.epochs + 1):
            state = self.algorithm.pre_epoch(state, self, epoch)
            idx_mat = self.epoch_indices()
            launches = self.photometric_launches()
            tracing = bool(profile_dir) and epoch == profile_epoch
            with (self._trace(profile_dir, epoch) if tracing else contextlib.nullcontext()):
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
                "steady_img_per_s": steady,
                "photometric_launches": self.photometric_launches() - launches,
                "mode": self.epoch_mode})
            self._record(self.epoch_stats[-1])

            ips = idx_mat.numel() / dt
            msg = (f"Epoch {epoch:4d}/{self.epochs:4d} "
                   + " ".join(f"[{k}] {v:.4f}" for k, v in means.items())
                   + f" [img/s] {ips:,.0f} [mode] {self.epoch_mode}")
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
                if knn_acc > self.best_metric:
                    self.best_metric = knn_acc
                    self.save_checkpoint("best_model", epoch=epoch)
                self.save_checkpoint("latest", epoch=epoch)

        self.state = state
        self.logger.print("Completed training. Beginning linear evaluation.",
                          mode="info")
        return self.perform_linear_eval()

    def train_safe(self) -> float:
        """`train()`; on an interrupt or error the full state is flushed to
        `<output_dir>/latest` before the exception goes on, so the run
        resumes from there with `load`."""
        try:
            return self.train()
        except (KeyboardInterrupt, Exception):
            try:
                self.save_checkpoint("latest")
                self.logger.print(
                    f"Interrupted: state saved to {self.output_dir}/latest", mode="error")
            except Exception as save_err:
                self.logger.print(f"Saving the interrupted state failed: {save_err}",
                                  mode="error")
            raise
