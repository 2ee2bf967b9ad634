"""Smoke check of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phase 0 prints the environment and fails at once without a CUDA card.
Phase 1 builds the hand-written kernels from the sources in this checkout.
Phase 2 holds each kernel against its plain PyTorch version on the card,
at the main path's shapes and at odd ones, and times it at the main path's
shape (the photometric kernel at batch 512, 32x32: warm in L2 and cold by
CUDA events, and by the profiler), beside the plain version and the least
time the card needs for the work. Then one float32 SimCLR step at a tiny
size on the card is held against the same step on the CPU, the path the
tests hold against the JAX package.
Phase 3 trains SimCLR ResNet-18 for one epoch at batch 512 on the full-size
synthetic CIFAR-10 through `python -m ssv_tpu_torch.main`'s entry point,
with KNN validation and the final linear probe, and checks that every train
step went through the kernels.
Phase 4 runs BYOL ResNet-18 from configs/byol.yaml (batch 512, cut to 2
epochs) through the same entry point: interrupted after epoch 1 by an
exception from a `pre_epoch` hook on the algorithm (so `train_safe` saves
`latest`), resumed with `-l`, probed; then `-t linear_eval -l` and
`-t get_features -l` on the run.
Phase 5 trains SimSiam, ReLIC and Barlow Twins ResNet-18 from their shipped
configs for 10 steps each through the Trainer.
Phase 6 holds one float32 step of each of BYOL, SimSiam (both target
modes), ReLIC and Barlow Twins at a tiny size on the card against the CPU,
and the linear probe's loop likewise.
Every training phase checks two photometric launches per train step. Any
failure raises; the line before the last holds the kernels' numbers, the
last line the JSON result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5          # kernel against plain version, max abs diff (float32)


def phase_env() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    sys.path.insert(0, HERE)
    from ssv_tpu_torch.ops.build import find_nvcc

    print(f"torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-1]}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    return card


def phase_build() -> None:
    from ssv_tpu_torch.ops import build

    t0 = time.perf_counter()
    path = build.build("photometric")
    build.load("photometric")
    print(f"[build] photometric.cu -> {os.path.relpath(path, HERE)} "
          f"in {time.perf_counter() - t0:.2f} s")


def phase_kernels(card: str) -> list[dict]:
    from ssv_tpu_torch.ops.photometric import (fused_photometric,
                                               photometric_reference)
    from ssv_tpu_torch.tools.measure import (l2_flush, photometric_bound,
                                             photometric_inputs, profiled_ms,
                                             times_ms)

    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    # the main path's shape, the most pixels the registers hold (16 a
    # thread), an odd shape, and one past 64x64 (a pass per op)
    for B, H, W in ((512, 32, 32), (64, 64, 64), (5, 7, 9), (3, 70, 65)):
        images, order, params, n = photometric_inputs(B, H, W, g)
        got = fused_photometric(images, order, params)
        want = photometric_reference(images, order, params)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"photometric kernel: non-finite output at {B}x{H}x{W}")
        err = (got - want).abs().max().item()
        print(f"[kernel] photometric B={B} {H}x{W}: max |kernel - plain| = {err:.3e}")
        if err > TOL:
            raise AssertionError(f"photometric kernel disagrees: {err} > {TOL}")
        if not torch.equal(got[:n], images[:n]):
            raise AssertionError("photometric kernel: identity factors changed the input")
        max_err = max(max_err, err)

    images, order, params, _ = photometric_inputs(512, 32, 32, g)

    def run():
        return fused_photometric(images, order, params)

    flush = l2_flush()
    warm, cold = [], []
    for _ in range(2):
        warm += times_ms(run)
        cold += times_ms(run, before=flush)
    ms, ms_cold = statistics.median(warm), statistics.median(cold)
    ms_profiler = profiled_ms({"kernel": run}, {"kernel": "photometric_kernel<"})["kernel"]
    plain_ms = statistics.median(times_ms(lambda: photometric_reference(images, order, params)))
    bound_ms, bound_by, nbytes, ops = photometric_bound(images, params)
    print(f"[kernel] photometric bound B=512 32x32: {nbytes:,} bytes, {ops:,.0f} float ops "
          f"-> {bound_ms * 1e3:.3f} us, bound by {bound_by}")
    print(f"[kernel] photometric B=512 32x32: event median warm {ms:.4f} ms, cold "
          f"{ms_cold:.4f} ms ({len(warm)} calls each); profiler "
          + (f"{ms_profiler * 1e3:.3f} us per launch" if ms_profiler else "saw no device time")
          + f"; plain version {plain_ms:.4f} ms | {card}")

    def share(t):
        return bound_ms / t if t else None

    return [{"name": "fused_photometric", "route": "cuda",
             "source": "ssv_tpu_torch/csrc/photometric.cu",
             "replaces": "ssv_tpu/ops/pallas/photometric.py:119",
             "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
             "ms_cold": ms_cold, "ms_profiler": ms_profiler,
             "bound_share_profiler": share(ms_profiler), "bound_share_cold": share(ms_cold),
             "card": card}]


# tiny float32 configs: a two-stage ResNet (128 features), 16x16, batch 8
SMALL_STEPS = {
    "simclr": {"proj_dim": 16, "loss_fn": {"normalize": True, "temperature": 0.5}},
    "byol": {"proj_dim": 16, "tau": 0.99},
    "simsiam": {"proj_dim": 32, "bottleneck_dim": 8},
    "simsiam-frozen": {"proj_dim": 32, "bottleneck_dim": 8, "target_mode": "frozen"},
    "relic": {"proj_dim": 16, "tau": 0.99,
              "loss_fn": {"normalize": True, "temperature": 1.0, "alpha": 0.5}},
    "barlow": {"proj_dim": 32, "loss_fn": {"normalize": False, "off_diagonal_weight": 0.005}},
}


def phase_small_steps(names) -> None:
    """One float32 step of each algorithm with a two-stage ResNet at 16x16,
    batch 8, on the card and on the CPU from the same weights and views: the
    CPU path is the one the tests hold against the JAX package. The views
    are given, so no kernel launches here. Loss within 1e-5 relative (to 1
    where the loss is nearer 0, as SimSiam's mean cosine is), every weight
    and BN statistic, the EMA target's included, within 1e-4."""
    from ssv_tpu_torch.models import registry
    from ssv_tpu_torch.models.resnet import BasicBlock, ResNet
    from ssv_tpu_torch.train.base import DataInfo
    from ssv_tpu_torch.train.registry import build_algorithm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    views = {k: torch.rand(8, 16, 16, 3, generator=g) for k in ("aug_1", "aug_2", "img")}
    resnet18 = registry.NETWORKS["resnet18"]
    registry.NETWORKS["resnet18"] = {
        "net": lambda **kw: ResNet(BasicBlock, (1, 1), **kw), "dim": 128}
    try:
        for name in names:
            algo_name = name.split("-")[0]
            cfg = {"epochs": 1, "compute_dtype": "float32",
                   "encoder": {"reduce_bottom_conv": True},
                   "optimizer": {"name": "sgd", "weight_decay": 1e-4,
                                 "lr": 0.001 if algo_name == "barlow" else 0.003},
                   "scheduler": {"name": "cosine", "warmup_epochs": 0},
                   **SMALL_STEPS[name]}
            results = {}
            for dev in ("cpu", "cuda"):
                algo = build_algorithm(algo_name, cfg, "resnet18", DataInfo(10, 64, 8, 8), dev)
                state = algo.init_state(torch.Generator().manual_seed(0))
                state, m = algo.train_step(state, {k: v.to(dev) for k, v in views.items()})
                tensors = {f"model.{k}": v for k, v in state.model.state_dict().items()}
                for part, module in state.extra.items():
                    tensors.update({f"{part}.{k}": v for k, v in module.state_dict().items()})
                results[dev] = (m["loss"].item(),
                                {k: v.float().cpu() for k, v in tensors.items()})
            (loss_cpu, sd_cpu), (loss_gpu, sd_gpu) = results["cpu"], results["cuda"]
            rel = abs(loss_gpu - loss_cpu) / max(1.0, abs(loss_cpu))
            param_err = max((sd_gpu[k] - sd_cpu[k]).abs().max().item() for k in sd_cpu)
            print(f"[step] {name} float32 16x16 batch 8, card against CPU: loss "
                  f"{loss_gpu:.6f}, rel diff {rel:.2e}, max |param diff| {param_err:.2e} "
                  f"over {len(sd_cpu)} tensors")
            if not (rel <= 1e-5 and param_err <= 1e-4):
                raise AssertionError(f"{name} step on the card disagrees with the CPU path")
    finally:
        registry.NETWORKS["resnet18"] = resnet18


def phase_probe_steps() -> None:
    """The linear probe's loop on the card against the CPU, from the same
    initial weights and index matrix, on features whose accuracy is neither
    chance nor 1: the same accuracy within one test sample."""
    from ssv_tpu_torch.evals.linear import train_probe

    g = torch.Generator().manual_seed(0)
    means = torch.randn(5, 24, generator=g) * 0.4

    def split(n):
        labels = torch.randint(0, 5, (n,), generator=g)
        return means[labels] + torch.randn(n, 24, generator=g), labels

    (x, y), (xt, yt) = split(600), split(400)
    inputs = (x, y, xt, yt, torch.randn(24, 5, generator=g) / 24 ** 0.5, torch.zeros(5),
              torch.randint(0, 600, (45, 64), generator=g))
    acc = {dev: train_probe({"lr": 0.1}, *(t.to(dev) for t in inputs))
           for dev in ("cpu", "cuda")}
    print(f"[probe] 45 steps of 64 x 24 features, card against CPU: accuracy "
          f"{acc['cuda']:.4f} against {acc['cpu']:.4f}")
    if abs(acc["cuda"] - acc["cpu"]) > 1 / len(yt) or not 0.3 < acc["cpu"] < 0.95:
        raise AssertionError(f"the probe on the card disagrees with the CPU: {acc}")


def phase_slice(card: str) -> dict:
    """One epoch of SimCLR ResNet-18 through the port's CLI entry point."""
    import yaml

    from ssv_tpu_torch import main as cli
    from ssv_tpu_torch.ops.photometric import fused_photometric
    from ssv_tpu_torch.train.trainer import STEADY_AFTER

    with open(os.path.join(HERE, "configs", "simclr.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["epochs"] = 1
    cfg["eval_every"] = 1
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "simclr.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
        torch.cuda.reset_peak_memory_stats()
        fused_photometric.launches = 0
        trainer = cli.main(["-c", cfg_path, "-m", "resnet18", "-a", "simclr",
                            "-t", "train", "-o", os.path.join(tmp, "run")])
        launches = fused_photometric.launches
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    stats = trainer.epoch_stats[-1]
    steps = stats["steps"]
    losses = stats["losses"]
    if launches != 2 * steps:
        raise AssertionError(f"photometric kernel launched {launches} times "
                             f"for {steps} train steps, expected {2 * steps}")
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite or missing train losses: {losses}")
    acc = trainer.best_metric
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"KNN accuracy {acc} outside [0, 1]")
    print(f"[slice] simclr resnet18 batch {trainer.pipeline.batch_size}: {steps} steps, "
          f"loss first {losses[0]:.4f} last {losses[-1]:.4f}, KNN accuracy {acc:.4f}")
    print(f"[slice] steady-state {stats['steady_img_per_s']:.1f} img/s "
          f"(steps {STEADY_AFTER + 1}-{steps}), peak memory "
          f"{peak / 2**30:.3f} GiB | {card}")
    probe = _check_probe("simclr", trainer, card)
    return {"launches": launches, "steps": steps, "knn_accuracy": acc,
            "img_per_s": stats["steady_img_per_s"], "peak_bytes": peak,
            "linear_eval": probe}


def _check_probe(name: str, trainer, card: str) -> dict:
    probe = trainer.linear_eval_stats
    if probe is None or not 0.0 <= probe["accuracy"] <= 1.0:
        raise AssertionError(f"{name}: linear probe accuracy {probe} outside [0, 1]")
    print(f"[probe] {name}: linear probe accuracy {probe['accuracy']:.4f}, "
          f"{probe['seconds']:.2f} s (features of both splits and "
          f"{trainer.config['linear_eval']['epochs']} epochs) | {card}")
    return probe


def _check_launches(name: str, launches: int, steps: int) -> None:
    if launches != 2 * steps:
        raise AssertionError(f"{name}: photometric kernel launched {launches} times "
                             f"for {steps} train steps, expected {2 * steps}")


def _free_memory() -> int:
    """Frees what earlier runs left and restarts the peak count; returns the
    bytes still allocated, which a run's own peak is read above."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _gib(nbytes: int) -> str:
    return f"{nbytes / 2**30:.3f} GiB"


class Interrupt(Exception):
    """Raised by phase 4's `pre_epoch` hook to stop a run after epoch 1."""


def phase_byol(card: str) -> dict:
    """BYOL ResNet-18 from configs/byol.yaml, cut to 2 epochs, through the
    CLI: stopped at the start of epoch 2 by an exception that `train_safe`
    sees, resumed with `-l`, then `linear_eval -l` and `get_features -l`."""
    import numpy as np
    import yaml

    from ssv_tpu_torch import main as cli
    from ssv_tpu_torch.ops.photometric import fused_photometric
    from ssv_tpu_torch.train import trainer as trainer_mod
    from ssv_tpu_torch.train.trainer import STEADY_AFTER

    with open(os.path.join(HERE, "configs", "byol.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["epochs"] = 2
    cfg["eval_every"] = 1
    first = {}

    def stop_after_epoch_1(state, trainer, epoch):
        target = list(state.extra["target"].parameters())
        if epoch == 1:
            first["target"] = [p.detach().clone() for p in target]
            return state
        first["stats"] = trainer.epoch_stats
        first["target_moved"] = max((p - q).abs().max().item()
                                    for p, q in zip(target, first.pop("target")))
        raise Interrupt

    def build_with_hook(*args, **kwargs):
        algo = build_algorithm(*args, **kwargs)
        algo.pre_epoch = stop_after_epoch_1
        return algo

    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "byol.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
        run = os.path.join(tmp, "run")
        argv = ["-c", cfg_path, "-m", "resnet18", "-a", "byol"]
        held = [_free_memory()]
        fused_photometric.launches = 0
        build_algorithm = trainer_mod.build_algorithm
        trainer_mod.build_algorithm = build_with_hook
        try:
            cli.main([*argv, "-t", "train", "-o", run])
        except Interrupt:
            pass
        else:
            raise AssertionError("the run was not interrupted at epoch 2")
        finally:
            trainer_mod.build_algorithm = build_algorithm
        saved = [n for n in ("latest", "best_model") if os.path.isfile(os.path.join(run, n))]
        if saved != ["latest", "best_model"] or not first["target_moved"] > 0:
            raise AssertionError(f"after the interrupt: checkpoints {saved}, EMA target "
                                 f"moved {first['target_moved']}")

        first_peak = torch.cuda.max_memory_allocated() - held[0]
        held.append(_free_memory())
        resumed = cli.main([*argv, "-t", "train", "-o", run, "-l", run])
        launches = fused_photometric.launches
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held[1]

        lin = cli.main([*argv, "-t", "linear_eval", "-o", os.path.join(tmp, "lin"),
                        "-l", run])
        feat_dir = os.path.join(tmp, "feat")
        cli.main([*argv, "-t", "get_features", "-o", feat_dir, "-l", run])
        shapes = {n: np.load(os.path.join(feat_dir, f"{n}.npy")).shape
                  for n in ("train_fvecs", "train_gt", "test_fvecs", "test_gt")}

    stats = first["stats"] + resumed.epoch_stats
    steps = resumed.state.step
    _check_launches("byol", launches, steps)
    if [e["epoch"] for e in stats] != [1, 2] or steps != sum(e["steps"] for e in stats):
        raise AssertionError(f"byol: epochs {[e['epoch'] for e in stats]}, {steps} steps")
    losses = [x for e in stats for x in e["losses"]]
    if not all(map(math.isfinite, losses)):
        raise AssertionError("byol: non-finite train losses")
    n_train, n_test = resumed.pipeline.n_train, resumed.pipeline.n_test
    dim = int(resumed.config["proj_dim"])
    want = {"train_fvecs": (n_train, dim), "train_gt": (n_train,),
            "test_fvecs": (n_test, dim), "test_gt": (n_test,)}
    if shapes != want:
        raise AssertionError(f"get_features wrote {shapes}, expected {want}")
    print(f"[byol] resnet18 batch {resumed.pipeline.batch_size}: epoch 1 "
          f"interrupted at epoch 2's start, `latest` and `best_model` saved, EMA target "
          f"moved by up to {first['target_moved']:.3e}; resumed at epoch "
          f"{resumed.epoch_stats[0]['epoch']}; {steps} steps in all, loss first "
          f"{losses[0]:.4f} last {losses[-1]:.4f}, KNN {resumed.best_metric:.4f}")
    print(f"[byol] steady-state {stats[0]['steady_img_per_s']:.1f} img/s (epoch 1) and "
          f"{stats[1]['steady_img_per_s']:.1f} img/s (epoch 2), steps {STEADY_AFTER + 1} "
          f"to the end of each; peak memory of each run above what was held before it "
          f"{_gib(first_peak)} (epoch 1 and its KNN eval; {_gib(held[0])} held before) and "
          f"{_gib(peak)} (resume, epoch 2, KNN, the probe; {_gib(held[1])} held before); "
          f"{launches} photometric launches for {steps} steps | {card}")
    probe = _check_probe("byol train", resumed, card)
    probe_task = _check_probe("byol -t linear_eval", lin, card)
    print(f"[byol] get_features: {shapes}")
    return {"launches": launches, "steps": steps, "peak_bytes": [first_peak, peak],
            "held_bytes": held,
            "img_per_s": [e["steady_img_per_s"] for e in stats],
            "linear_eval": probe, "linear_eval_task": probe_task}


def phase_family(card: str) -> dict:
    """SimSiam, ReLIC and Barlow Twins ResNet-18 from their shipped configs,
    10 train steps each through the Trainer. Returns the launches of each."""
    from ssv_tpu_torch.ops.photometric import fused_photometric
    from ssv_tpu_torch.train.trainer import STEADY_AFTER, Trainer

    out = {}
    for name in ("simsiam", "relic", "barlow"):
        held = _free_memory()
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer({"config": os.path.join(HERE, "configs", f"{name}.yaml"),
                               "algo": name, "arch": "resnet18", "task": "train",
                               "output": os.path.join(tmp, "run")})
            idx_mat = trainer.pipeline.epoch_indices(trainer.generator)[:10]
            target = trainer.state.extra.get("target")
            before = [p.detach().clone() for p in target.parameters()] if target else []
            fused_photometric.launches = 0
            state, metrics, steady = trainer._run_epoch(trainer.state, idx_mat)
            launches = fused_photometric.launches
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
        losses = metrics["loss"].tolist()
        _check_launches(name, launches, state.step)
        if state.step != 10 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name}: {state.step} steps, losses {losses}")
        moved = None
        if before:   # ReLIC's EMA target
            moved = max((p - q).abs().max().item()
                        for p, q in zip(state.extra["target"].parameters(), before))
            if not moved > 0:
                raise AssertionError(f"{name}: the EMA target did not move")
        print(f"[family] {name} resnet18 batch {trainer.pipeline.batch_size}: 10 steps, "
              f"loss first {losses[0]:.4f} last {losses[-1]:.4f}"
              + (f", EMA target moved by up to {moved:.3e}" if moved is not None else "")
              + f"; {steady:.1f} img/s (steps {STEADY_AFTER + 1}-10), peak memory "
              f"{_gib(peak)} above the {_gib(held)} held before; {launches} photometric "
              f"launches | {card}")
        out[name] = {"launches": launches, "steps": state.step, "img_per_s": steady,
                     "peak_bytes": peak, "held_bytes": held}
        del trainer, state, target, before, metrics
    return out


def main() -> None:
    card = phase_env()
    phase_build()
    kernels = phase_kernels(card)
    phase_small_steps(["simclr"])
    paths = {"simclr": phase_slice(card)["launches"],
             "byol": phase_byol(card)["launches"]}
    paths.update({k: v["launches"] for k, v in phase_family(card).items()})
    phase_small_steps(["byol", "simsiam", "simsiam-frozen", "relic", "barlow"])
    phase_probe_steps()
    kernels[0]["launches"] = sum(paths.values())
    kernels[0]["launches_by_path"] = paths
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
