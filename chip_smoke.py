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
with KNN validation, and checks that every train step went through the
kernels. Any failure raises; the line before the last holds the kernels'
numbers, the last line the JSON result.
"""

from __future__ import annotations

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


def phase_small_step() -> None:
    """One SimCLR step of a two-stage ResNet at 16x16, batch 8, in float32,
    on the card and on the CPU from the same weights and views: the CPU path
    is the one the tests hold against the JAX package. The views are given,
    so no kernel launches here."""
    from ssv_tpu_torch.models.heads import simclr_projection
    from ssv_tpu_torch.models.resnet import BasicBlock, ResNet
    from ssv_tpu_torch.train.algorithms.common import Tower
    from ssv_tpu_torch.train.algorithms.simclr import SimCLR
    from ssv_tpu_torch.train.base import DataInfo

    cfg = {"epochs": 1, "proj_dim": 16, "compute_dtype": "float32",
           "optimizer": {"name": "sgd", "lr": 0.003, "weight_decay": 1e-4},
           "scheduler": {"name": "cosine", "warmup_epochs": 0},
           "loss_fn": {"normalize": True, "temperature": 0.5}}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    views = {k: torch.rand(8, 16, 16, 3, generator=g) for k in ("aug_1", "aug_2")}
    results = {}
    for dev in ("cpu", "cuda"):
        algo = SimCLR(cfg, "resnet18", DataInfo(10, 64, 8, 8), dev)
        algo.model = Tower(ResNet(BasicBlock, (1, 1), reduce_bottom_conv=True),
                           simclr_projection(128, 16))
        state = algo.init_state(torch.Generator().manual_seed(0))
        state, m = algo.train_step(state, {k: v.to(dev) for k, v in views.items()})
        results[dev] = (m["loss"].item(),
                        {k: v.float().cpu() for k, v in state.model.state_dict().items()})
    (loss_cpu, sd_cpu), (loss_gpu, sd_gpu) = results["cpu"], results["cuda"]
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    param_err = max((sd_gpu[k] - sd_cpu[k]).abs().max().item() for k in sd_cpu)
    print(f"[step] simclr float32 16x16 batch 8, card against CPU: loss rel diff "
          f"{rel:.2e}, max |param diff| {param_err:.2e}")
    if not (rel <= 1e-5 and param_err <= 1e-4):
        raise AssertionError("SimCLR step on the card disagrees with the CPU path")


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
    return {"launches": launches, "steps": steps, "knn_accuracy": acc,
            "img_per_s": stats["steady_img_per_s"], "peak_bytes": peak}


def main() -> None:
    card = phase_env()
    phase_build()
    kernels = phase_kernels(card)
    phase_small_step()
    slice_ = phase_slice(card)
    kernels[0]["launches"] = slice_["launches"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
