"""Smoke check of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phase 0 prints the environment and fails at once without a CUDA card.
Phase 1 builds the hand-written kernels from the sources in this checkout.
Phase 2 holds each kernel against its plain PyTorch version on the card, at
the main path's shapes and at an odd shape, and times both; then one float32
SimCLR step at a tiny size on the card is held against the same step on the
CPU, the path the tests hold against the JAX package.
Phase 3 trains SimCLR ResNet-18 for one epoch at batch 512 on the full-size
synthetic CIFAR-10 through `python -m ssv_tpu_torch.main`'s entry point,
with KNN validation, and checks that every train step went through the
kernels. Any failure raises; the last line is the JSON result.
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
TIMING_RUNS = 50
SPIN_CYCLES = 100_000_000  # about 50 ms of one SM's clock: longer than queueing the runs


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


def _photometric_inputs(B, H, W, g):
    """Random params plus the edge cases: gate off (identity), hue shift
    +-0.5, gray gate 1, equal-channel images (delta 0) and all-zero images."""
    from ssv_tpu_torch.ops.photometric import sample_photometric_params

    dev = "cuda"
    images = torch.rand(B, H, W, 3, generator=g, device=dev)
    order, params = sample_photometric_params(
        B, {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4, "hue": 0.1},
        0.2, 0.8, g, dev)
    n = max(B // 8, 1)
    params[0:n] = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0], device=dev)
    params[n:2 * n, 3] = 0.5
    params[2 * n:3 * n, 3] = -0.5
    params[3 * n:4 * n, 4] = 1.0
    images[4 * n:5 * n] = images[4 * n:5 * n, ..., :1].expand(-1, -1, -1, 3)
    images[5 * n:6 * n] = 0.0
    return images.contiguous(), order.contiguous(), params.contiguous(), n


def _median_ms(fn, runs=TIMING_RUNS):
    """Median device time of one call over `runs` calls, each between its own
    pair of CUDA events. A spin kernel queued first keeps the card busy while
    the host queues every call, so the events time the device and not the
    launch path. After a warm-up call the inputs stay in L2, as they are when
    the pipeline calls the op right after producing them."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(runs)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in pairs)


def phase_kernels(card: str) -> list[dict]:
    from ssv_tpu_torch.ops.photometric import (fused_photometric,
                                               photometric_reference)

    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    # the main path's shape, an odd one, and one past the registers' 64x64
    for B, H, W in ((512, 32, 32), (5, 7, 9), (3, 70, 65)):
        images, order, params, n = _photometric_inputs(B, H, W, g)
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

    images, order, params, _ = _photometric_inputs(512, 32, 32, g)
    plain_ms = _median_ms(lambda: photometric_reference(images, order, params))
    ms = _median_ms(lambda: fused_photometric(images, order, params))
    print(f"[kernel] photometric B=512 32x32, median device time of {TIMING_RUNS} calls: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms | {card}")
    return [{"name": "fused_photometric", "route": "cuda",
             "source": "ssv_tpu_torch/csrc/photometric.cu",
             "replaces": "ssv_tpu/ops/pallas/photometric.py:119",
             "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}]


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
