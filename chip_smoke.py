"""Smoke check of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phase 0 prints the environment and fails at once without a CUDA card.
Phase 1 builds the hand-written kernels from the sources in this checkout.
Phase 2 holds each kernel against its plain PyTorch version on the card by
running the kernels' `card` tests (CARD_TESTS: `python -m pytest -m card
--noconftest` over the photometric, stem and attention test files, in
their own process), which must all pass with none skipped; then times each
kernel at the main path's shapes: the photometric kernel at batch 512,
32x32 (warm in L2 and cold by CUDA events, and by the profiler) beside the
plain version and the least time the card needs for the work; the ResNet
stem's kernels (`ops/stem.py`, through `stem_tail`'s autograd Function, a
training forward and backward) at batch 1,024 and 512, 32 x 32 x 64 bf16,
by events and by the profiler (each kernel), beside the plain version, the
least time their bytes need, and aten's composition (what the port ran
before, `library_ms`); the ViT's attention kernels (`ops/attention.py`,
forward and backward through `attention`, 6 heads of 64) at 256 sequences
of 65 tokens (the global crops) and 768 of 5 (the local crops), by events
and by the profiler (each kernel), beside the plain version, the least
time their bytes need and `F.scaled_dot_product_attention` (`library_ms`,
a yardstick the port never calls). Then one float32 SimCLR step at a tiny
size on the card is held against the same step on the CPU, the path the
tests hold against the JAX package, on a two-stage BasicBlock ResNet, a
two-stage Bottleneck ResNet with 4 groups of width 4, and the TinyEncoder.
Phase 3 trains SimCLR ResNet-18 for one epoch at batch 512 on the full-size
synthetic CIFAR-10 through `python -m ssv_tpu_torch.main`'s entry point,
with KNN validation and the final linear probe, and checks that every train
step went through the kernels.
Phase `graph` (after phase 3) holds the epoch as one device program, the
JAX package's default `jit_epoch`: for SimCLR ResNet-18 and BYOL ResNet-18
at batch 512, DINO's ViT at 64, and each other algorithm at 128, 3 eager
warm-up steps and 10 CUDA-graph replays in float32 against 13 eager steps
from the same state and generator state, bit for bit (losses, state, the
generator after; cuDNN's deterministic algorithms), with the photometric
launches, replays counted; the first replayed step's views against the
eager step's (SimCLR, DINO) and the kernel replayed from a graph against
its plain version. Every training phase in one process runs in graph mode
and prints it (`[mode]`).
Phase `bench` (after phase `graph`) runs the port's measurement entry
points, each in its own process as a user runs it: `python -m
ssv_tpu_torch.bench` at bench.py's shape (batch 512, 100 steps an epoch,
8,192 images; its line strict, every key, graph mode, its timed epoch all
100 replays of one graph with 200 photometric launches, a finite loss, the
card's MFU), `python -m ssv_tpu_torch.tools.bench_augment 512` (every
variant timed, the kernel's and the plain version's), and `python -m
ssv_tpu_torch.tools.profile_report --capture` (the bench's timed epoch
traced and read: device ops, duty, ms by kind, the photometric kernel
twice a step).
Phase 3b trains SimCLR ResNet-50 (`-m resnet50`) the same way, counts the
model's FLOPs for the MFU, and runs `-t linear_eval -l` on its checkpoint.
Phase 3c trains SimCLR for 10 steps each on ResNet-101, ResNet-152,
ResNeXt-50 32x4d, ResNeXt-101 32x8d, Wide ResNet-50-2, Wide ResNet-101-2 and
`tiny` through the Trainer, on FAMILY_SIZES synthetic images.
Phase 3d holds every transform op of slice C (Gaussian blur, random crop,
resize to 24 and 40, cutout, RandAugment and each of its 14 branches) on a
batch of 512 train images on the card against the CPU from the same draws,
times each, and trains SimCLR ResNet-18 for 10 steps with a train view that
runs them all.
Phase 4 runs BYOL ResNet-18 from configs/byol.yaml (batch 512, cut to 2
epochs) through the same entry point: interrupted after epoch 1 by an
exception from a `pre_epoch` hook on the algorithm (so `train_safe` saves
`latest`), resumed with `-l`, probed; then `-t linear_eval -l` and
`-t get_features -l` on the run.
Phase 5 trains SimSiam, ReLIC and Barlow Twins ResNet-18 from their shipped
configs for 10 steps each through the Trainer.
Phase 6 holds one float32 step of each of BYOL, SimSiam (both target
modes), ReLIC, Barlow Twins, MoCo, SwAV and SeLA at a tiny size on the card
against the CPU, and the linear probe's loop likewise.
Phase 7 runs MoCo ResNet-18 from configs/moco.yaml (batch 256, queue 1000,
cut to 2 epochs) through the CLI, interrupted at epoch 2's start and
resumed with `-l` as phase 4 does, and checks the queue's pointer and that
the key tower moved.
Phase 8 trains SwAV ResNet-18 from configs/swav.yaml (batch 512, 3000
prototypes and bank rows) for one epoch through the CLI, and checks that
`pre_train` filled every bank row.
Phase 9 trains SeLA ResNet-18 from configs/sela.yaml (batch 500, 10 heads of
128 clusters, cut to 2 epochs) through the CLI, with its two self-labelling
sweeps (`pre_train` and epoch 1), and checks that the pseudo-labels use more
than one cluster.
Phase 10 runs DINO on the ViT from configs/dino.yaml (hidden 384, cut from
6 layers to DINO_LAYERS, batch 64 with 2+2 global 32x32 and 6+6 local 8x8
crops, adamw; cut to 2 epochs) through the CLI, interrupted at epoch 2's start and resumed with
`-l` as phase 4 does; checks that the teacher after the epoch-1 EMA is
lambda * (the teacher before) + (1 - lambda) * (the student), that the
center moved from its randn draw, and that the probe took the 1,024-wide
student output. Phase 2 also times the kernel at DINO's batch of 64, and
phase 6 holds a float32 DINO step (a small ViT, and a small ResNet with
unfused views) on the card against the CPU.
Phase 11 runs PIRL ResNet-18 from configs/pirl.yaml (batch 256, 16x16
patches, 4 a view, 1,000 negatives, bank momentum 0.5; cut to 2 epochs)
through the CLI, interrupted at epoch 2's start and resumed with `-l` as
phase 4 does: the bank after the resume equals the bank at the stop bit for
bit, the rows epoch 2 touched (and only those) changed, every row is finite.
Phase 12 runs DeepCluster ResNet-18 from configs/deep_cluster.yaml (batch
512, K-means of 300 iterations x 10 restarts over the 50,000 x 512 features
at each epoch's start; cut to 2 epochs) through the CLI, interrupted and
resumed likewise: the pseudo-labels after the resume equal those at the
stop, and cover every train index with values in [0, 10); it prints the
seconds of `map_train`, K-means and the Hungarian step of each epoch.
Phase 6 also holds a float32 PIRL step (JAX-free fixed draws) and a
DeepCluster step on the card against the CPU.
Phase 13 (`ddp`) trains across ranks: (a) SimCLR ResNet-18 as phase 3
(its probe cut to one epoch), through `torchrun --standalone
--nproc_per_node 1 -m ssv_tpu_torch.main` (NCCL), its per-step losses
against phase 3's, its img/s beside phase 3's,
2 launches a step; (b) two ranks sharing the card over gloo (NCCL refuses
two ranks on one device), spawned: every collective of the slice on CUDA
tensors, two float32 steps of full-width SimCLR ResNet-18 on given views
against the one-process step (params 1e-4, BN statistics 1e-5), and
DDP_STEPS bf16 steps of the Trainer at global batch 512 (on DDP_SIZES
synthetic images) with sync BN and then with
`per_device_bn` (finite losses, the ranks' states bit for bit the same, 2
launches a step at B = 256 on each rank); then the photometric wrapper on a
tensor of a device that is not the current one, where a second device
exists (it says so where none does).
Phase 9 also sets `SSV_TPU_PROFILE_DIR` on its run (not resumed): the
`Trainer` writes one `torch.profiler` trace, of epoch 2 alone, and the
phase checks that it spans epoch 2's steps and names the photometric
kernel's CUDA function once a step.
Phase `quality` runs `python -m ssv_tpu_torch.tools.quality_run` through its
entry point: SimCLR ResNet-18 from configs/simclr.yaml on synth100 at full
size (50,000 / 10,000) for 2 epochs with a KNN each and the probe (the JSON
line strict, 2 curve points, the probe's accuracy in (0, 1]); then a run on
`tiny` whose parameters a `pre_epoch` hook fills with NaN at epoch 1: the row
says `nan_at` 1, `linear` null, and the probe never ran; then a short
shapes100 row (SwAV ResNet-18 from configs/swav.yaml, SHAPES_EPOCHS epochs
on SHAPES_SIZES), which `python -m ssv_tpu_torch.tools.quality_parity
--join ... --keys-only` reads back from the run's log: the joined row's keys
and curve whole, one graph captured in the row (its quality is not judged). Phase 2 also times
the kernel at the sweep's batches: 250 (SeLA), 32 (DINO's row by its name)
and 8 (the batch that row runs).
Phase `cifar` stages real-layout CIFAR-10 without JAX: a pickle-layout
tarball of CIFAR_SIZES images written from a numpy seed (made here, not
downloaded), staged by `python -m ssv_tpu_torch.tools.fetch_cifar --from` in
its own process (which writes the `.raw` cache); the pickle directory is
then moved away, and SimCLR ResNet-18 from configs/simclr.yaml trains one
epoch on the staged root through the CLI, so its start reads the cache:
not the synthetic fallback, the images and labels the tarball holds, the
cache not rewritten, 2 photometric launches a step.
Phase `sweep` runs the 12 rows of `python -m ssv_tpu_torch.tools.sweep` (the
synthetic set cut to SWEEP_SIZES, SWEEP_EPOCHS epochs each) and prints each
row's img/s beside its committed floor; the floors are no gate here.
Phase `tp` runs the model axis (SwAV's prototype table sharded over a
model group) on ranks sharing the card over gloo: (a) SwAV ResNet-18 at
configs/swav.yaml's widths at data 1 x model 2 (1,500 prototype rows a
rank), two float32 steps on given views against the one-process step
(the loss 1e-5 relative, the gathered table and the tower: params 1e-4, BN
statistics 1e-5), then TP_STEPS bf16 steps at batch 512 (finite losses, the tower
and the bank bit for bit the same on both ranks, 2 launches a step a rank;
the collectives, MB and host ms a step); (b) the dry run's DPxTP phase at
4 ranks (2 x 2) on CUDA tensors; (c) the native IO library built by g++,
its CIFAR binary reader against its NumPy version bit for bit on a
50,000 + 10,000-row binary directory written from a seed, and two
`load_dataset` calls, the first writing the `.raw` cache and the second
reading it, both timed.
Every CLI run but phase 3's, and the quality runner's, probes for
PROBE_EPOCHS epochs (phase 3 keeps the shipped 100).
Every training phase checks the photometric launches per train step (two,
a graph replay counted as the launches its capture recorded;
one for SeLA's single augmented view; DeepCluster builds and pays for the
`aug_2` it never reads), and, where its Trainer runs in this process
(not the quality runner's, the sweep's, the bench's or the ranks'), the
stem kernels' launches per train step (STEM_LAUNCHES_PER_STEP on a ResNet,
none on the ViT or `tiny`): the epoch records' `stem_launches`, or the
counter around `Trainer._run_epoch`; where it runs through the CLI, the
attention kernels' too (the epoch records' `attention_launches`:
ATTENTION_LAUNCHES_PER_LAYER a layer a step on a bf16 ViT with heads of
64, none elsewhere). It prints its steady img/s and its peak
memory above what it inherited, and checks that what each run inherits stays
within 64 MiB of what the first run inherited. Each phase prints its
seconds (`[time]`). Any failure raises; the line before the last holds the
kernels' numbers, the last line the JSON result.
"""

from __future__ import annotations

import copy
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
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5          # kernel against plain version, max abs diff (float32)
HELD_SLACK = 64 << 20   # bytes a run may inherit beyond what the first run did
# photometric launches per train step on each path: two train views, or
# SeLA's one augmented view
LAUNCHES_PER_STEP = {"simclr": 2, "byol": 2, "simsiam": 2, "relic": 2, "barlow": 2,
                     "moco": 2, "swav": 2, "sela": 1, "dino": 2, "pirl": 2,
                     "deep_cluster": 2}
# stem launches per train step on a ResNet: each backbone call with a
# gradient 6 (statistics, merge, normalise-pool; reduce, merge, elementwise),
# each without one (a target or key tower under no_grad) 3; the views run
# one at a time
STEM_LAUNCHES_PER_STEP = {"simclr": 12, "byol": 18, "simsiam": 12, "relic": 24,
                          "barlow": 12, "moco": 9, "swav": 12, "sela": 6, "dino": 0,
                          "pirl": 12, "deep_cluster": 6}
# the kernels' `card` tests, which hold each kernel to its plain version
CARD_TESTS = ("tests/test_torch_photometric_card.py", "tests/test_torch_stem.py",
              "tests/test_torch_attention.py")
CARD_TESTS_TIMEOUT_S = 900
STEM_TIMED_BATCHES = (1024, 512)   # both views of batch 512 at once, and one view
# the attention kernels' timed calls, (sequences, tokens): a DINO step's at
# batch 64, the global crops and the local crops
ATTENTION_TIMED = ((256, 65), (768, 5))
ATTENTION_KERNELS = ("vit_attn_fwd", "vit_attn_bwd")
# attention launches a ViT layer a train step: DINO's teacher forward over
# the global crops, the student's over the global and the local crops, the
# student's two backwards
ATTENTION_LAUNCHES_PER_LAYER = {"dino": 5}
BF16_FLOPS = 989e12   # H100 SXM dense bf16 peak (NVIDIA data sheet, at 700 W)
# the batches the paths give the kernel: 512 (SimCLR, BYOL, SimSiam, ReLIC,
# Barlow, SwAV, DeepCluster), 256 (MoCo, PIRL, the sweep), 500 (SeLA), 64
# (DINO, whose two base transforms run before the multi-crop), 250 (the
# sweep's SeLA row), 32 (the sweep's DINO row by its name) and 8 (the batch
# that row runs: mini_config's DINO data block sets it); the first is the
# main path's
TIMED_BATCHES = (512, 256, 500, 64, 250, 32, 8)


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

    for name in ("photometric", "phase_mark", "stem", "attention"):
        t0 = time.perf_counter()
        path = build.build(name)
        build.load(name)
        print(f"[build] {name}.cu -> {os.path.relpath(path, HERE)} "
              f"in {time.perf_counter() - t0:.2f} s")


def _card_tests() -> None:
    """`pytest -m card` over CARD_TESTS in its own process, from this
    checkout: every test passes and none skips (a card is present)."""
    import xml.etree.ElementTree as ET

    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "card.xml")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pytest", "-m", "card", "--noconftest",
                               "-q", "-p", "no:cacheprovider", f"--junitxml={report}",
                               *CARD_TESTS], cwd=HERE, capture_output=True, text=True,
                              timeout=CARD_TESTS_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        output = f"{proc.stdout[-6000:]}\n{proc.stderr[-3000:]}"
        if not os.path.exists(report):
            raise AssertionError(f"pytest -m card wrote no report, exit {proc.returncode}:\n"
                                 f"{output}")
        suite = next(ET.parse(report).getroot().iter("testsuite"))
    counts = {k: int(suite.get(k, 0)) for k in ("tests", "failures", "errors", "skipped")}
    print(f"[kernel] pytest -m card over {', '.join(CARD_TESTS)}: {counts['tests']} tests, "
          f"{counts['failures']} failed, {counts['errors']} errors, {counts['skipped']} "
          f"skipped, exit {proc.returncode}, {seconds:.1f} s")
    if proc.returncode != 0 or not counts["tests"] or any(
            counts[k] for k in ("failures", "errors", "skipped")):
        raise AssertionError(f"the kernels' card tests did not all pass:\n{output}")


def phase_kernels(card: str) -> list[dict]:
    _card_tests()
    g = torch.Generator(device="cuda").manual_seed(0)
    by_batch = [_time_photometric(B, g, card) for B in TIMED_BATCHES]
    main = by_batch[0]
    max_err = max(r["max_abs_err"] for r in by_batch)

    def share(t):
        return main["bound_ms"] / t if t else None

    return [{"name": "fused_photometric", "route": "cuda",
             "source": "ssv_tpu_torch/csrc/photometric.cu",
             "replaces": "ssv_tpu/ops/pallas/photometric.py:119",
             "max_abs_err": max_err, "ms": main["ms"], "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
             "ms_cold": main["ms_cold"], "ms_profiler": main["ms_profiler"],
             "bound_share_profiler": share(main["ms_profiler"]),
             "bound_share_cold": share(main["ms_cold"]), "by_batch": by_batch,
             "card": card},
            _stem_kernels(card), _attention_kernels(card)]


STEM_KERNELS = ("stem_bn_fw_stats", "stem_bn_fw_merge", "stem_bn_fw_relu_max",
                "stem_bn_bw_reduce", "stem_bn_bw_merge", "stem_bn_bw_elemt")


def _stem_inputs(N: int, H: int, W: int, dtype, g):
    """A channels-last conv output, its stem BN (random affine and running
    statistics) and a pooled gradient, from the generator `g`."""
    from ssv_tpu_torch.models.resnet import BatchNorm2d

    C = 64
    x = (0.5 + 1.5 * torch.randn(N, H, W, C, device="cuda", generator=g)).to(dtype)
    bn = BatchNorm2d(C).cuda()
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn(C, device="cuda", generator=g))
        bn.bias.copy_(0.2 * torch.randn(C, device="cuda", generator=g))
    gy = torch.randn(N, (H - 1) // 2 + 1, (W - 1) // 2 + 1, C, device="cuda", generator=g)
    return x.permute(0, 3, 1, 2), bn, gy.to(dtype).permute(0, 3, 1, 2)


def _stem_kernels(card: str) -> dict:
    """The stem's kernels timed (the module docstring's phase 2)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    by_batch = [_time_stem(B, g, card) for B in STEM_TIMED_BATCHES]
    main = by_batch[0]
    return {"name": "stem_tail", "route": "cuda", "source": "ssv_tpu_torch/csrc/stem.cu",
            "replaces": None, "ms": main["ms"],
            "ms_profiler": main["ms_profiler"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": main["library_ms"],
            "bound_share_profiler": main["bound_share_profiler"], "by_batch": by_batch,
            "card": card}


def _time_stem(B: int, g, card: str) -> dict:
    """A training forward and backward through the stem's kernels at batch
    B, 32x32x64 bf16 (warm in L2), by events and by the profiler, beside the
    plain version, the least time the bytes need and aten's composition."""
    from ssv_tpu_torch.ops import stem as S
    from ssv_tpu_torch.tools.measure import HBM_BYTES_PER_S, profiled_ms, times_ms

    x, bn, gy = _stem_inputs(B, 32, 32, torch.bfloat16, g)
    x.requires_grad_()
    _, lib_bn, _ = _stem_inputs(1, 1, 1, torch.bfloat16, g)

    def run():
        return torch.autograd.grad(S.stem_tail(x, bn), (x, bn.weight, bn.bias), gy)

    def plain():
        stats = S.plain_stats(x.detach(), bn)
        y, _, _ = S.plain_tail(x.detach(), stats)
        return S.plain_backward(x.detach(), y, gy, stats, bn.weight)

    def library():
        out = S.stem_reference(x, lib_bn)
        return torch.autograd.grad(out, (x, lib_bn.weight, lib_bn.bias), gy)

    ms = statistics.median(times_ms(run))
    per_kernel = profiled_ms({"kernel": run}, {k: k for k in STEM_KERNELS})
    ms_profiler = (sum(per_kernel.values()) if all(v is not None for v in per_kernel.values())
                   else None)
    plain_ms = statistics.median(times_ms(plain))
    library_ms = statistics.median(times_ms(library))
    nbytes = S.stem_bytes(x)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    share = bound_ms / ms_profiler if ms_profiler else None
    print(f"[kernel] stem bound B={B} 32x32x64 bf16: {nbytes:,} bytes -> "
          f"{bound_ms * 1e3:.3f} us, bound by bytes")
    print(f"[kernel] stem B={B}: forward and backward event median {ms:.4f} ms; profiler "
          + (" + ".join(f"{k[8:]} {v * 1e3:.2f}" for k, v in per_kernel.items())
             + f" = {ms_profiler * 1e3:.2f} us, {share:.3f} of the bound"
             if ms_profiler else "saw no device time")
          + f"; plain version {plain_ms:.4f} ms; aten's composition {library_ms:.4f} ms | {card}")
    return {"batch": B, "ms": ms, "ms_profiler": ms_profiler, "per_kernel_ms": per_kernel,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bytes": nbytes, "bound_share_profiler": share}


def _attention_inputs(b: int, n: int, g):
    """q, k, v (b, n, 6, 64) bf16, views of the Linear outputs, and an
    output gradient, from the generator `g`."""
    q, k, v = ((1.5 * torch.randn(b, n, 384, device="cuda", generator=g)).bfloat16()
               .unflatten(-1, (6, 64)) for _ in range(3))
    return q, k, v, torch.randn(b, n, 384, device="cuda", generator=g).bfloat16()


def _attention_kernels(card: str) -> dict:
    """The attention kernels timed (the module docstring's phase 2)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    by_shape = [_time_attention(b, n, g, card) for b, n in ATTENTION_TIMED]
    # a DINO step at batch 64 a layer: the teacher's forward and the
    # student's forward and backward at 65 tokens, the student's at 5
    step_ms = 6 * (by_shape[0]["fwd_ms"] + by_shape[0]["ms"] + by_shape[1]["ms"])
    step_bound = 6 * (by_shape[0]["fwd_bound_ms"] + by_shape[0]["bound_ms"]
                      + by_shape[1]["bound_ms"])
    print(f"[kernel] attention in a DINO ViT step (6 layers, events): {step_ms:.4f} ms, "
          f"bound {step_bound:.4f} ms, {step_bound / step_ms:.3f} of it | {card}")
    main = by_shape[0]
    return {"name": "vit_attention", "route": "cuda", "source": "ssv_tpu_torch/csrc/attention.cu",
            "replaces": None, "ms": main["ms"],
            "ms_profiler": main["ms_profiler"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": main["library_ms"], "bound_share_profiler": main["bound_share_profiler"],
            "dino_step_ms": step_ms, "dino_step_bound_ms": step_bound, "by_shape": by_shape,
            "card": card}


def _time_attention(b: int, n: int, g, card: str) -> dict:
    """Forward and backward through the attention kernels at (b, n, 6, 64)
    bf16 (warm in L2), by events and by the profiler (each kernel), the
    forward alone without a gradient, beside the plain version, the least
    time the bytes need and F.scaled_dot_product_attention."""
    from ssv_tpu_torch.ops import attention as A
    from ssv_tpu_torch.tools.measure import HBM_BYTES_PER_S, profiled_ms, times_ms

    q, k, v, gy = _attention_inputs(b, n, g)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def run():
        return torch.autograd.grad(A.attention(*leaves)[0], leaves, gy)

    def forward():
        with torch.no_grad():
            return A.attention(q, k, v)

    def plain():
        return torch.autograd.grad(A.attention_reference(*leaves)[0], leaves, gy)

    def library():
        out = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in leaves))
        return torch.autograd.grad(out.transpose(1, 2).reshape(b, n, 384), leaves, gy)

    ms = statistics.median(times_ms(run))
    fwd_ms = statistics.median(times_ms(forward))
    per_kernel = profiled_ms({"kernel": run}, {k: k for k in ATTENTION_KERNELS})
    ms_profiler = (sum(per_kernel.values()) if all(v is not None for v in per_kernel.values())
                   else None)
    plain_ms = statistics.median(times_ms(plain))
    library_ms = statistics.median(times_ms(library))
    nbytes, fwd_bytes = A.attention_bytes(q), A.attention_bytes(q, backward=False)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    fwd_bound_ms = fwd_bytes / HBM_BYTES_PER_S * 1e3
    share = bound_ms / ms_profiler if ms_profiler else None
    print(f"[kernel] attention ({b}, {n}, 6, 64) bf16: forward and backward {nbytes:,} bytes "
          f"-> {bound_ms * 1e3:.3f} us, forward {fwd_bytes:,} -> {fwd_bound_ms * 1e3:.3f} us; "
          f"events: forward and backward {ms:.4f} ms, forward alone {fwd_ms:.4f} ms; profiler "
          + (" + ".join(f"{k} {v * 1e3:.2f}" for k, v in per_kernel.items())
             + f" = {ms_profiler * 1e3:.2f} us, {share:.3f} of the bound"
             if ms_profiler else "saw no device time")
          + f"; plain version {plain_ms:.4f} ms; F.scaled_dot_product_attention "
          f"{library_ms:.4f} ms | {card}")
    return {"shape": [b, n, 6, 64], "ms": ms, "fwd_ms": fwd_ms, "ms_profiler": ms_profiler,
            "per_kernel_ms": per_kernel, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "fwd_bound_ms": fwd_bound_ms, "bytes": nbytes,
            "bound_share_profiler": share}


def _time_photometric(B: int, g, card: str) -> dict:
    """The kernel at batch B, 32x32: held against the plain version, then
    timed warm in L2 and cold by CUDA events and by the profiler, beside the
    plain version and the least time the card needs for the work."""
    from ssv_tpu_torch.ops.photometric import (fused_photometric,
                                               photometric_reference)
    from ssv_tpu_torch.tools.measure import (l2_flush, photometric_bound,
                                             photometric_inputs, profiled_ms,
                                             times_ms)

    images, order, params, _ = photometric_inputs(B, 32, 32, g)

    def run():
        return fused_photometric(images, order, params)

    err = (run() - photometric_reference(images, order, params)).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"photometric kernel disagrees at B={B}: {err} > {TOL}")
    flush = l2_flush()
    warm, cold = [], []
    for _ in range(2):
        warm += times_ms(run)
        cold += times_ms(run, before=flush)
    ms, ms_cold = statistics.median(warm), statistics.median(cold)
    ms_profiler = profiled_ms({"kernel": run}, {"kernel": "photometric_kernel<"})["kernel"]
    plain_ms = statistics.median(times_ms(lambda: photometric_reference(images, order, params)))
    bound_ms, bound_by, nbytes, ops = photometric_bound(images, params)
    share = bound_ms / ms_profiler if ms_profiler else None
    print(f"[kernel] photometric bound B={B} 32x32: {nbytes:,} bytes, {ops:,.0f} float ops "
          f"-> {bound_ms * 1e3:.3f} us, bound by {bound_by}")
    print(f"[kernel] photometric B={B} 32x32: max |kernel - plain| = {err:.3e}; event median "
          f"warm {ms:.4f} ms, cold {ms_cold:.4f} ms ({len(warm)} calls each); profiler "
          + (f"{ms_profiler * 1e3:.3f} us per launch, {share:.3f} of the bound"
             if ms_profiler else "saw no device time")
          + f"; plain version {plain_ms:.4f} ms | {card}")
    return {"batch": B, "max_abs_err": err, "ms": ms, "ms_cold": ms_cold,
            "ms_profiler": ms_profiler, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "bound_share_profiler": share}


# tiny float32 configs: a two-stage ResNet (128 features), 16x16, batch 8
SMALL_STEPS = {
    "simclr": {"proj_dim": 16, "loss_fn": {"normalize": True, "temperature": 0.5}},
    "byol": {"proj_dim": 16, "tau": 0.99},
    "simsiam": {"proj_dim": 32, "bottleneck_dim": 8},
    "simsiam-frozen": {"proj_dim": 32, "bottleneck_dim": 8, "target_mode": "frozen"},
    "relic": {"proj_dim": 16, "tau": 0.99,
              "loss_fn": {"normalize": True, "temperature": 1.0, "alpha": 0.5}},
    "barlow": {"proj_dim": 32, "loss_fn": {"normalize": False, "off_diagonal_weight": 0.005}},
    "moco": {"proj_dim": 16, "queue_size": 64, "momentum": 0.99,
             "loss_fn": {"normalize": True, "temperature": 0.07}},
    "swav": {"hidden_dim": 32, "proj_dim": 16, "prototype_size": 40, "feature_bank_size": 48,
             "loss_fn": {"temperature": 0.1, "sinkhorn_eps": 0.05, "sinkhorn_iters": 3}},
    "sela": {"num_clusters": 8, "num_cluster_heads": 3, "lambda": 25, "self_label_iters": 5},
    "pirl": {"proj_dim": 16, "patch_size": 8, "num_patches": 4, "num_negatives": 24,
             "momentum": 0.5, "loss_fn": {"normalize": True, "temperature": 0.07}},
    "deep_cluster": {"num_classes": 4},
}
# DINO at a tiny size: a 2-layer ViT of width 32 on 16x16 globals (16
# patches) and 8x8 locals (4), or the small ResNet with unfused views
_DINO_SMALL = {
    "optimizer": {"name": "adamw", "lr": 1e-4, "epsilon": 1e-6, "weight_decay": 0.04},
    "gradient_clip": 3.0, "proj_head": {"hidden_dim": 24, "proj_dim": 16},
    "encoder": {"hidden_dim": 32, "embedding_dim": 16, "intermediate_dim": 48,
                "num_attention_heads": 2, "patch_size": 4, "num_encoder_layers": 2,
                "num_global_patches": 16, "num_local_patches": 4},
    "data": {"multicrop_config": {"global_size": [16, 16], "local_size": [8, 8]}}}
SMALL_STEPS.update({"dino": _DINO_SMALL, "dino-resnet": _DINO_SMALL,
                    "simclr-bottleneck": SMALL_STEPS["simclr"],
                    "simclr-tiny": SMALL_STEPS["simclr"]})
# `resnet50` stands for a two-stage Bottleneck ResNet with 4 groups of width
# 4 (512 features) here
SMALL_ARCH = {"dino": "vit", "simclr-bottleneck": "resnet50", "simclr-tiny": "tiny"}


def phase_small_steps(names) -> None:
    """One float32 step of each algorithm with a two-stage ResNet (DINO's
    `dino` case: a 2-layer ViT; `simclr-bottleneck`: a two-stage Bottleneck
    ResNet with 4 groups of width 4; `simclr-tiny`: the TinyEncoder) at
    16x16, batch 8 (DINO: 2+2 16x16 global
    and 2+2 8x8 local crops of each), on the card and on the CPU from the
    same weights and views: the CPU path is the one the tests hold against
    the JAX package. The views are given, so no kernel launches here; so
    are PIRL's draws (a patch permutation and 24 negative rows) and bank
    (random unit rows), and the pseudo-labels of SeLA and DeepCluster. Loss
    within 1e-5 relative (to 1 where the loss is nearer 0, as SimSiam's mean
    cosine is), every weight, BN statistic and buffer (an EMA target, key
    tower or teacher, a queue or bank and its pointer, SeLA's alpha, beta,
    pseudo-labels and best head, DINO's center, PIRL's bank, DeepCluster's
    pseudo-labels) within 1e-4."""
    from ssv_tpu_torch.models import registry
    from ssv_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNet
    from ssv_tpu_torch.train.base import DataInfo
    from ssv_tpu_torch.train.registry import build_algorithm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    views = {k: torch.rand(8, 16, 16, 3, generator=g) for k in ("aug_1", "aug_2", "img")}
    views["aug"] = views["aug_1"]
    views["idx"] = views["index"] = torch.randperm(64, generator=g)[:8]
    perm, negatives = torch.randperm(4, generator=g), torch.randperm(64, generator=g)[:24]
    bank = torch.nn.functional.normalize(torch.randn(64, 16, generator=g), dim=1)
    for k, size in (("global_1", 16), ("global_2", 16), ("local_1", 8), ("local_2", 8)):
        views[k] = torch.rand(8, 2, size, size, 3, generator=g)
    saved = {k: registry.NETWORKS[k] for k in ("resnet18", "resnet50")}
    registry.NETWORKS["resnet18"] = {
        "net": lambda **kw: ResNet(BasicBlock, (1, 1), **kw), "dim": 128}
    registry.NETWORKS["resnet50"] = {
        "net": lambda **kw: ResNet(Bottleneck, (1, 1), groups=4, width_per_group=4, **kw),
        "dim": 512}
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
                algo = build_algorithm(algo_name, cfg, SMALL_ARCH.get(name, "resnet18"),
                                       DataInfo(10, 64, 8, 8), dev)
                state = algo.init_state(torch.Generator().manual_seed(0))
                if algo_name == "sela":
                    labels = state.extra["self_label"].pseudo_labels
                    labels.copy_(torch.arange(64) % 8)
                elif algo_name == "deep_cluster":
                    state.extra["pseudo_labels"].labels.copy_(torch.arange(64) % 4)
                elif algo_name == "pirl":
                    state.extra["bank"].data.copy_(bank)
                    algo.draw = lambda g, b, idx, dev=dev: (perm.to(dev),
                                                            b.data[negatives.to(dev)])
                state, m = algo.train_step(state, {k: v.to(dev) for k, v in views.items()},
                                           None)
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
        registry.NETWORKS.update(saved)


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


# ----------------------------------------------------------------------
# what each run inherits, and its own peak above that
# ----------------------------------------------------------------------
_HELD: list[int] = []


def _held_before_run(name: str) -> int:
    """Frees what earlier runs left, restarts the peak count, and returns the
    bytes still allocated, which the run's own peak is read above. Fails if
    they exceed what the first run inherited by more than HELD_SLACK: a run
    that leaves its trainer's tensors on the card, or makes streams of its
    own (cuBLAS keeps a workspace, 64 MiB on the H100, for every stream it
    ran on until the process ends)."""
    gc.collect()
    if not _HELD:
        _warm_workspaces()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _HELD.append(held)
    print(f"[memory] before {name}: {_gib(held)} held; before the first run {_gib(_HELD[0])}")
    if held > _HELD[0] + HELD_SLACK:
        raise AssertionError(f"{name}: {_gib(held)} held before the run, more than "
                             f"{_gib(HELD_SLACK)} above the {_gib(_HELD[0])} held before "
                             f"the first run: an earlier run left tensors on the card")
    return held


def _warm_workspaces() -> None:
    """A float32 and a bf16 Linear forward and backward on the default
    stream and on the one stream every trainer's graph warms up and is
    captured on (`train/graph.py`): cuBLAS's workspaces for each pair of
    thread (this one, autograd's) and stream a trainer uses, made before
    the first held-memory reading, so the baseline holds them and a run
    that makes a stream of its own shows."""
    from ssv_tpu_torch.train.graph import side_stream

    lin = torch.nn.Linear(64, 64, device="cuda")
    x = torch.ones(8, 64, device="cuda")
    side = side_stream(torch.device("cuda"))
    side.wait_stream(torch.cuda.current_stream())
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            for bf16 in (False, True):
                with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
                    y = lin(x)
                y.float().sum().backward()
    torch.cuda.synchronize()


def _gib(nbytes: int) -> str:
    return f"{nbytes / 2**30:.3f} GiB"


def _reset_launches() -> None:
    """The counts of kernel launches (`utils/trace.py`'s `LAUNCHES`:
    photometric and stem) to 0."""
    from ssv_tpu_torch.utils import trace

    for name in trace.LAUNCHES:
        trace.counters[name] = 0


def _launches() -> int:
    """The photometric kernel's launches since `_reset_launches`: the
    wrapper's (a captured step's launches count once, as its graph's first
    replay) and those of every later replay of a graph."""
    from ssv_tpu_torch.utils import trace

    return trace.counters.get("photometric.launches", 0)


def _stem_launches() -> int:
    """The stem kernels' launches since `_reset_launches`, counted as the
    photometric kernel's are; eval's (KNN, the probe) included."""
    from ssv_tpu_torch.utils import trace

    return trace.counters.get("stem.launches", 0)


def _check_launches(name: str, launches: int, steps: int) -> None:
    want = LAUNCHES_PER_STEP[name] * steps
    if launches != want:
        raise AssertionError(f"{name}: photometric kernel launched {launches} times "
                             f"for {steps} train steps, expected {want}")


def _check_stem(name: str, model, launches: int, steps: int) -> int:
    """The stem kernels' `launches` in `steps` train steps of `model`:
    STEM_LAUNCHES_PER_STEP a step on a ResNet, none without one."""
    from ssv_tpu_torch.models.resnet import ResNet

    resnet = any(isinstance(m, ResNet) for m in model.modules())
    want = STEM_LAUNCHES_PER_STEP[name] * steps if resnet else 0
    if launches != want:
        raise AssertionError(f"{name}: stem kernels launched {launches} times in {steps} "
                             f"train steps, expected {want}")
    return launches


def _epoch_stem(name: str, model, stats: list[dict]) -> int:
    """`_check_stem` over the epoch records `stats` (`stem_launches`: the
    epoch's steps', not its KNN eval's)."""
    return _check_stem(name, model, sum(e["stem_launches"] for e in stats),
                       sum(e["steps"] for e in stats))


def _epoch_attention(name: str, model, stats: list[dict]) -> int:
    """The attention kernels' launches in the epoch records `stats`
    (`attention_launches`): ATTENTION_LAUNCHES_PER_LAYER a layer a step on
    a bf16 ViT whose heads are HEAD_DIM wide, none elsewhere (the module
    keeps the composition for other widths and for float32)."""
    from ssv_tpu_torch.models.vit import TransformerEncoder
    from ssv_tpu_torch.ops.attention import HEAD_DIM

    launches, steps = (sum(e[k] for e in stats) for k in ("attention_launches", "steps"))
    vits = [m for m in model.modules() if isinstance(m, TransformerEncoder)
            and m.dtype in (None, torch.bfloat16)
            and m.hidden_dim // m.layers[0].attention.num_heads == HEAD_DIM]
    want = ATTENTION_LAUNCHES_PER_LAYER[name] * len(vits[0].layers) * steps if vits else 0
    if launches != want:
        raise AssertionError(f"{name}: attention kernels launched {launches} times in {steps} "
                             f"train steps, expected {want}")
    return launches


def _check_probe(name: str, trainer, card: str) -> dict:
    probe = trainer.linear_eval_stats
    if probe is None or not 0.0 <= probe["accuracy"] <= 1.0:
        raise AssertionError(f"{name}: linear probe accuracy {probe} outside [0, 1]")
    print(f"[probe] {name}: linear probe accuracy {probe['accuracy']:.4f}, "
          f"{probe['seconds']:.2f} s (features of both splits and "
          f"{trainer.config['linear_eval']['epochs']} epochs) | {card}")
    return dict(probe)


def _check_mode(name: str, mode: str) -> None:
    """A run in one process on the card trains in graph mode, the JAX
    package's default (`jit_epoch`): its step captured once and replayed."""
    print(f"[mode] {name}: {mode}")
    if mode != "graph":
        raise AssertionError(f"{name}: trained in {mode} mode, expected graph")


def _check_losses(name: str, stats: list[dict]) -> list[float]:
    for mode in sorted({e["mode"] for e in stats}):
        _check_mode(name, mode)
    losses = [x for e in stats for x in e["losses"]]
    if len(losses) != sum(e["steps"] for e in stats) or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{name}: non-finite or missing train losses: {losses}")
    return losses


# the final linear probe's epochs on every path but phase 3's (the main
# path's keeps the shipped 100): the probe's depth, about 6 s a run at 100
PROBE_EPOCHS = 10


def _config(tmp: str, name: str, probe_epochs: int | None = PROBE_EPOCHS,
            **overrides) -> str:
    """configs/<name>.yaml with its probe cut to `probe_epochs` (None: as
    shipped) and top-level `overrides`, written to `tmp`."""
    import yaml

    with open(os.path.join(HERE, "configs", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    if probe_epochs is not None:
        cfg["linear_eval"] = {**cfg["linear_eval"], "epochs": probe_epochs}
    cfg.update(overrides)
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


class _Hooks:
    """Wraps the CLI's `build_algorithm` so a run's algorithm gets extra
    hooks, restored on exit."""

    def __init__(self, **hooks):
        self.hooks = hooks

    def __enter__(self):
        from ssv_tpu_torch.train import trainer as trainer_mod

        self.mod, self.build = trainer_mod, trainer_mod.build_algorithm

        def build_with_hooks(*args, **kwargs):
            algo = self.build(*args, **kwargs)
            for name, wrap in self.hooks.items():
                setattr(algo, name, wrap(getattr(algo, name)))
            return algo

        trainer_mod.build_algorithm = build_with_hooks
        return self

    def __exit__(self, *exc):
        self.mod.build_algorithm = self.build
        return False


# ----------------------------------------------------------------------
# the paths
# ----------------------------------------------------------------------
def phase_slice(card: str) -> dict:
    """One epoch of SimCLR ResNet-18 through the port's CLI entry point."""
    from ssv_tpu_torch import main as cli
    from ssv_tpu_torch.train.trainer import STEADY_AFTER

    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = _config(tmp, "simclr", probe_epochs=None, epochs=1, eval_every=1)
        held = _held_before_run("simclr")
        _reset_launches()
        trainer = cli.main(["-c", cfg_path, "-m", "resnet18", "-a", "simclr",
                            "-t", "train", "-o", os.path.join(tmp, "run")])
        launches = _launches()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held

    stats = trainer.epoch_stats[-1]
    steps = stats["steps"]
    _check_launches("simclr", launches, steps)
    stem = _epoch_stem("simclr", trainer.state.model, [stats])
    losses = _check_losses("simclr", [stats])
    acc = trainer.best_metric
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"KNN accuracy {acc} outside [0, 1]")
    print(f"[slice] simclr resnet18 batch {trainer.pipeline.batch_size}: {steps} steps, "
          f"loss first {losses[0]:.4f} last {losses[-1]:.4f}, KNN accuracy {acc:.4f}")
    print(f"[slice] steady-state {stats['steady_img_per_s']:.1f} img/s "
          f"(steps {STEADY_AFTER + 1}-{steps}), peak memory {_gib(peak)} above the "
          f"{_gib(held)} held before | {card}")
    probe = _check_probe("simclr", trainer, card)
    return {"launches": launches, "stem_launches": stem, "steps": steps, "knn_accuracy": acc,
            "img_per_s": stats["steady_img_per_s"], "peak_bytes": peak, "held_bytes": held,
            "linear_eval": probe, "losses": losses}


def _train_gflop_per_view(model, algorithm, batch: int = 8) -> tuple[float, float]:
    """GFLOP a 32x32 view takes through `model` (a copy, in train mode, on
    the card, in the algorithm's autocast), forward and forward plus
    backward, as torch.utils.flop_counter counts the matmuls and
    convolutions."""
    from torch.utils.flop_counter import FlopCounterMode

    model = copy.deepcopy(model).train()
    x = torch.rand(batch, 32, 32, 3, device="cuda")
    with FlopCounterMode(display=False) as fwd, algorithm.autocast():
        model(x)
    with FlopCounterMode(display=False) as both, algorithm.autocast():
        model(x).float().sum().backward()
    del model
    return fwd.get_total_flops() / batch / 1e9, both.get_total_flops() / batch / 1e9


# the graph phase: graph replays against eager steps, the captured views
# and kernel, and the two modes' speed in turns
GRAPH_REPLAYS = 10     # replayed steps held against as many eager ones
# (name, arch, batch, config overrides): the three paths of the first
# benchmark at their configs' batches, then a short row for each other
# algorithm at batch 128
GRAPH_ROWS = (("simclr", "resnet18", 512, {}), ("byol", "resnet18", 512, {}),
              ("dino", "vit", 64, {"encoder": "layers"}),
              ("moco", "resnet18", 128, {}), ("swav", "resnet18", 128, {}),
              ("simsiam", "resnet18", 128, {}), ("relic", "resnet18", 128, {}),
              ("barlow", "resnet18", 128, {}), ("sela", "resnet18", 128, {}),
              ("deep_cluster", "resnet18", 128, {}), ("pirl", "resnet18", 128, {}))


def _graph_trainer(name: str, arch: str, batch: int, n_train: int, jit_epoch: bool,
                   float32: bool, encoder: str | None = None):
    """A Trainer of configs/<name>.yaml at `batch` on `n_train` synthetic
    images, in the mode `jit_epoch` gives, writing nothing."""
    import yaml

    from ssv_tpu_torch.train.trainer import Trainer

    overrides = {"jit_epoch": jit_epoch, "data": {"batch_size": batch}}
    if float32:
        overrides["compute_dtype"] = "float32"
    if encoder == "layers":
        with open(os.path.join(HERE, "configs", "dino.yaml")) as f:
            overrides["encoder"] = {**yaml.safe_load(f)["encoder"],
                                    "num_encoder_layers": DINO_LAYERS}
    return Trainer({"config": os.path.join(HERE, "configs", f"{name}.yaml"), "algo": name,
                    "arch": arch, "task": "train", "output": "graph"}, overrides=overrides,
                   synthetic_sizes=(n_train, batch), make_dirs=False)


def _one_epoch(trainer) -> dict:
    """pre_train (and DeepCluster's pre_epoch), then one epoch; the losses,
    the state on the host, the generator's state after, the graph's
    numbers."""
    state = trainer.algorithm.pre_train(trainer.state, trainer)
    if trainer.algorithm.name == "deep_cluster":
        state = trainer.algorithm.pre_epoch(state, trainer, 1)
    _reset_launches()
    state, metrics, _ = trainer._run_epoch(state, trainer.epoch_indices())
    torch.cuda.synchronize()
    tensors = {f"model.{k}": v.detach().cpu() for k, v in state.model.state_dict().items()}
    for name, module in state.extra.items():
        tensors.update({f"{name}.{k}": v.detach().cpu()
                        for k, v in module.state_dict().items()})
    from ssv_tpu_torch.utils import trace

    graph = trainer.graph
    return {"losses": metrics["loss"].tolist(), "tensors": tensors, "step": state.step,
            "counter": int(state.counter), "generator": trainer.generator.get_state(),
            "mode": trainer.epoch_mode, "launches": _launches(),
            "stem": _check_stem(trainer.algorithm.name, state.model, _stem_launches(),
                                state.step),
            "graph": None if graph is None else {
                "held": graph.held, "replays": graph.replays,
                "capture_s": trace.last_seconds("graph.capture"),
                "pool_bytes": graph.pool_bytes}}


def _graph_agreement(name: str, arch: str, batch: int, extra: dict) -> dict:
    """WARMUP_STEPS + GRAPH_REPLAYS float32 steps from one state and one
    generator state, eagerly and in graph mode (the warm-up's steps eager,
    then replays): the largest difference in the per-step losses and in the
    state, the first step where they part, the generator states after."""
    from ssv_tpu_torch.train.graph import WARMUP_STEPS

    steps = WARMUP_STEPS + GRAPH_REPLAYS
    runs = {}
    # cuDNN's deterministic algorithms: in float32 (TF32 off) its default
    # weight gradients may sum with atomics, and two eager runs then differ
    torch.backends.cudnn.deterministic = True
    try:
        for jit_epoch in (False, True):
            trainer = _graph_trainer(name, arch, batch, steps * batch, jit_epoch, True,
                                     extra.get("encoder"))
            runs[jit_epoch] = _one_epoch(trainer)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    eager, graph = runs[False], runs[True]
    if eager["mode"] != "step" or graph["mode"] != "graph":
        raise AssertionError(f"graph {name}: modes {eager['mode']} and {graph['mode']}")
    g = graph["graph"]
    if g["replays"] != GRAPH_REPLAYS or graph["step"] != steps or graph["counter"] != steps:
        raise AssertionError(f"graph {name}: {g['replays']} replays, host step "
                             f"{graph['step']}, counter {graph['counter']}; expected "
                             f"{GRAPH_REPLAYS}, {steps}, {steps}")
    parted = next((s for s, (a, b) in enumerate(zip(eager["losses"], graph["losses"]))
                   if a != b), None)
    loss_diff = max(abs(a - b) for a, b in zip(eager["losses"], graph["losses"]))
    state_diff = max((a.double() - b.double()).abs().max().item()
                     for a, b in zip(eager["tensors"].values(), graph["tensors"].values())
                     if a.numel())
    same = (parted is None and state_diff == 0
            and torch.equal(eager["generator"], graph["generator"]))
    want = LAUNCHES_PER_STEP[name] * steps
    print(f"[graph] {name} {arch} float32 batch {batch}: {WARMUP_STEPS} eager warm-up steps "
          f"and {GRAPH_REPLAYS} replays against {steps} eager steps: losses "
          f"{'bit for bit' if parted is None else f'part at step {parted + 1}'} (largest "
          f"difference {loss_diff:.3e}), state {state_diff:.3e} (tolerance 0: bit for bit), "
          f"generator state after {'equal' if torch.equal(eager['generator'], graph['generator']) else 'differs'}; "
          f"capture {g['capture_s']:.3f} s, pool {_gib(g['pool_bytes'])}, "
          f"{g['held']['photometric.launches']} photometric and "
          f"{g['held']['stem.launches']} stem launches captured, "
          f"{graph['launches']} and {graph['stem']} in all")
    if not same:
        raise AssertionError(f"graph {name}: the replays differ from the eager steps")
    if graph["launches"] != want or eager["launches"] != want:
        raise AssertionError(f"graph {name}: {graph['launches']} and {eager['launches']} "
                             f"photometric launches for {steps} steps, expected {want}")
    return {"loss_diff": loss_diff, "state_diff": state_diff, "steps": steps,
            "launches": graph["launches"] + eager["launches"],
            "stem_launches": graph["stem"] + eager["stem"], **g}


def _graph_views(card: str) -> None:
    """The first replayed step's views against the eager step's from the same
    generator state, bit for bit (SimCLR's double batch at 512, DINO's
    multi-crop at 64); and the photometric kernel replayed from a graph
    against its plain version on the replay's inputs."""
    from ssv_tpu_torch.ops.photometric import fused_photometric, photometric_reference
    from ssv_tpu_torch.tools.measure import photometric_inputs
    from ssv_tpu_torch.train.graph import side_stream

    # the trainers' one graph stream: a stream of its own would keep
    # cuBLAS workspaces (the RRC's matmuls) that the held-memory check reads
    side = side_stream(torch.device("cuda"))
    for name, arch, batch, extra in GRAPH_ROWS[:3:2]:
        trainer = _graph_trainer(name, arch, batch, 2 * batch, True, False,
                                 extra.get("encoder"))
        images, labels = trainer.pipeline.arrays("train")
        idx = trainer.epoch_indices()[0]
        start = trainer.generator.get_state()
        eager = [trainer._batch_fn(images, labels, idx, trainer.generator) for _ in range(2)]
        trainer.generator.set_state(start)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            trainer._batch_fn(images, labels, idx, trainer.generator)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(trainer.generator)
        with torch.cuda.graph(graph, stream=side):
            views = trainer._batch_fn(images, labels, idx, trainer.generator)
        graph.replay()
        torch.cuda.synchronize()
        differ = [k for k in views if not torch.equal(views[k], eager[1][k])]
        print(f"[graph] {name}: the first replayed step's views "
              f"({', '.join(sorted(views))}) against the eager step's: "
              f"{'bit for bit' if not differ else f'{differ} differ'}")
        if differ:
            raise AssertionError(f"graph {name}: replayed views {differ} differ")
        del trainer, graph, views, eager
    g = torch.Generator(device="cuda").manual_seed(1)
    images, order, params, _ = photometric_inputs(512, 32, 32, g)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_photometric(images, order, params)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fused_photometric(images, order, params)
    errs = []
    for seed in (2, 3):
        fresh = photometric_inputs(512, 32, 32, torch.Generator(device="cuda").manual_seed(seed))
        for t, f in zip((images, order, params), fresh[:3]):
            t.copy_(f)
        graph.replay()
        errs.append((out - photometric_reference(images, order, params)).abs().max().item())
    print(f"[graph] the photometric kernel replayed from a graph on two fresh 512 x 32 x 32 "
          f"batches: max |kernel - plain| {max(errs):.3e} (tolerance {TOL}) | {card}")
    if max(errs) > TOL:
        raise AssertionError(f"graph: the replayed kernel differs from its plain version")
    _reset_launches()


def phase_graph(card: str) -> dict:
    """The epoch as one device program (`jit_epoch`, the JAX package's
    default): (a) for SimCLR ResNet-18, BYOL ResNet-18 and DINO's ViT at
    their configs' batches, and a short row for each other algorithm,
    WARMUP_STEPS + GRAPH_REPLAYS float32 steps in graph mode against as many
    eager steps from the same state and generator state, bit for bit
    (losses, state, the generator after), with the photometric launches,
    replays counted; (b) the first replayed step's views against the eager
    step's, and the kernel replayed from a graph against its plain version."""
    out = {"agreement": {}}
    launches = stem = 0
    for name, arch, batch, extra in GRAPH_ROWS:
        row = _graph_agreement(name, arch, batch, extra)
        out["agreement"][name] = row
        launches += row["launches"]
        stem += row["stem_launches"]
    _graph_views(card)
    out["launches"], out["stem_launches"] = launches, stem
    return out


BENCH_TIMEOUT_S = 300   # each entry point's limit in phase `bench`
BENCH_KEYS = {"metric", "value", "unit", "batch", "model_tflops_per_sec_per_chip", "mfu",
              "steps", "n_train", "mode", "flops_per_image", "flops_by", "final_loss",
              "peak_memory_gib", "capture_s", "replays", "photometric_launches", "card"}
AUGMENT_KEYS = ("two_view_pallas_us", "two_view_xla_us", "photometric_pallas_us",
                "photometric_xla_us", "geometric_tail_us", "full_step_us",
                "aug_share_of_step", "aug_share_of_step_pallas", "geo_tail_share_of_step")


def _entry_point(args: list[str], cwd: str) -> dict:
    """`python -m <args>` from `cwd` with this checkout on the path: its last
    line, a JSON object; fails on a non-zero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd,
                          env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
                          text=True, timeout=BENCH_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"python -m {' '.join(args)} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    print(f"[bench] python -m {' '.join(args)}: {time.perf_counter() - t0:.1f} s")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_bench(card: str) -> dict:
    """The port's measurement entry points on the card: the bench at
    bench.py's shape, `bench_augment` at 512, `profile_report --capture`."""
    line = _entry_point(["ssv_tpu_torch.bench"], HERE)
    print(f"[bench] {json.dumps(line)}")
    steps = line.get("steps")
    if (set(line) != BENCH_KEYS or (line["batch"], steps, line["n_train"], line["mode"])
            != (512, 100, 8192, "graph") or line["replays"] != steps
            or line["photometric_launches"] != LAUNCHES_PER_STEP["simclr"] * steps
            or not math.isfinite(line["final_loss"]) or not line["value"] > 0
            or line["capture_s"] is None or line["mfu"] is None or line["card"] != card):
        raise AssertionError(f"bench: the line is not the bench's full-shape graph-mode line "
                             f"on this card: {line}")
    print(f"[bench] {line['value']:.1f} img/s, {line['flops_per_image'] / 1e9:.4f} GFLOP an "
          f"image ({line['flops_by']}), {line['model_tflops_per_sec_per_chip']:.2f} TFLOP/s, "
          f"MFU {line['mfu']:.4f}, peak {line['peak_memory_gib']:.3f} GiB, capture "
          f"{line['capture_s']:.3f} s; the timed epoch {line['replays']} replays of one graph, "
          f"{line['photometric_launches']} photometric launches | {card}")
    aug = _entry_point(["ssv_tpu_torch.tools.bench_augment", "512"], HERE)
    if any(not aug.get(k) or aug[k] <= 0 for k in AUGMENT_KEYS):
        raise AssertionError(f"bench_augment: a variant missing or not timed: {aug}")
    print("[bench] bench_augment at 512: " + ", ".join(
        f"{k} {aug[k]:.4f}" if "share" in k else f"{k} {aug[k]:.1f}" for k in AUGMENT_KEYS)
        + f" | {card}")
    with tempfile.TemporaryDirectory() as tmp:
        prof = _entry_point(["ssv_tpu_torch.tools.profile_report", "--capture"], tmp)
    photometric = prof["ops_by_kind"].get("photometric kernel")
    if not 0 < prof["duty"] <= 1 or photometric != LAUNCHES_PER_STEP["simclr"] * 100:
        raise AssertionError(f"profile_report --capture: {photometric} photometric kernels "
                             f"for 100 steps, {prof}")
    print(f"[bench] profile_report --capture: {prof['device_ops']:,} device ops over the "
          f"100-step epoch, wall {prof['wall_ms']:.3f} ms, busy {prof['busy_ms']:.3f} ms "
          f"(duty {prof['duty']:.4f}); ms by kind " + ", ".join(
              f"{k} {v:.3f}" for k, v in prof["ms_by_kind"].items()) + f" | {card}")
    return {"launches": line["photometric_launches"], "line": line, "augment": aug,
            "profile": {k: prof[k] for k in ("device_ops", "wall_ms", "busy_ms", "duty",
                                              "ms_by_kind", "ops_by_kind")}}


def phase_resnet50(card: str) -> dict:
    """The slice's path: SimCLR ResNet-50 from configs/simclr.yaml (batch
    512) through the CLI for one epoch with KNN and the probe, then
    `-t linear_eval -l` on its checkpoint. Prints the steady img/s, the MFU
    against the bf16 peak from the model's FLOPs, the peak memory above what
    the run inherits, and the probe's seconds."""
    from ssv_tpu_torch import main as cli
    from ssv_tpu_torch.train.trainer import STEADY_AFTER

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["-c", _config(tmp, "simclr", epochs=1, eval_every=1), "-m", "resnet50",
                "-a", "simclr"]
        run = os.path.join(tmp, "run")
        held = _held_before_run("simclr resnet50")
        _reset_launches()
        trainer = cli.main([*argv, "-t", "train", "-o", run])
        launches = _launches()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        stats = trainer.epoch_stats[-1]
        steps = stats["steps"]
        _check_launches("simclr", launches, steps)
        stem = _epoch_stem("simclr", trainer.state.model, [stats])
        losses = _check_losses("simclr resnet50", [stats])
        fwd, both = _train_gflop_per_view(trainer.state.model, trainer.algorithm)
        img_s = stats["steady_img_per_s"]
        mfu = img_s * 2 * both * 1e9 / BF16_FLOPS
        print(f"[resnet50] simclr resnet50 batch {trainer.pipeline.batch_size}: {steps} steps, "
              f"loss first {losses[0]:.4f} last {losses[-1]:.4f}, KNN accuracy "
              f"{trainer.best_metric:.4f}; {launches} photometric launches")
        print(f"[resnet50] steady-state {img_s:.1f} img/s (steps {STEADY_AFTER + 1}-{steps}); "
              f"the model {fwd:.4f} GFLOP forward and {both:.4f} forward plus backward a view "
              f"(torch.utils.flop_counter), so MFU {mfu * 100:.2f} % of "
              f"{BF16_FLOPS / 1e12:.0f} TFLOP/s; peak memory {_gib(peak)} above the "
              f"{_gib(held)} held before | {card}")
        probe = _check_probe("simclr resnet50", trainer, card)
        del trainer
        lin_held = _held_before_run("simclr resnet50 -t linear_eval")
        lin = cli.main([*argv, "-t", "linear_eval", "-o", os.path.join(tmp, "lin"), "-l", run])
        lin_probe = _check_probe("simclr resnet50 -t linear_eval", lin, card)
        del lin
    return {"launches": launches, "stem_launches": stem, "steps": steps, "img_per_s": img_s,
            "mfu": mfu, "gflop_per_view": [fwd, both], "peak_bytes": peak, "held_bytes": [held, lin_held],
            "linear_eval": probe, "linear_eval_task": lin_probe}


# the rest of the Bottleneck family and the test backbone, 10 SimCLR steps each
FAMILY_C = ("resnet101", "resnet152", "resnext50", "resnext101", "wide_resnet50",
            "wide_resnet101", "tiny")
FAMILY_SIZES = (10 * 512, 1024)   # synthetic train and test images: 10 steps' worth


def phase_bottleneck_family(card: str) -> dict:
    """SimCLR from configs/simclr.yaml (batch 512) on each arch of FAMILY_C,
    10 train steps each through the Trainer: img/s of steps 6-10, the
    forward GFLOP a view, the peak memory above what each run inherits."""
    from ssv_tpu_torch.train.trainer import STEADY_AFTER, Trainer

    out = {}
    for arch in FAMILY_C:
        held = _held_before_run(arch)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer({"config": os.path.join(HERE, "configs", "simclr.yaml"),
                               "algo": "simclr", "arch": arch, "task": "train",
                               "output": os.path.join(tmp, "run")},
                              synthetic_sizes=FAMILY_SIZES)
            idx_mat = trainer.pipeline.epoch_indices(trainer.generator)[:10]
            _reset_launches()
            state, metrics, steady = trainer._run_epoch(trainer.state, idx_mat)
            launches, stem = _launches(), _stem_launches()
            _check_mode(arch, trainer.epoch_mode)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
            fwd, _ = _train_gflop_per_view(state.model, trainer.algorithm)
        losses = metrics["loss"].tolist()
        _check_launches("simclr", launches, state.step)
        _check_stem("simclr", state.model, stem, state.step)
        if state.step != 10 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{arch}: {state.step} steps, losses {losses}")
        print(f"[bottleneck] simclr {arch} batch {trainer.pipeline.batch_size}: 10 steps, loss "
              f"first {losses[0]:.4f} last {losses[-1]:.4f}; {steady:.1f} img/s (steps "
              f"{STEADY_AFTER + 1}-10), {fwd:.4f} GFLOP forward a view; peak memory "
              f"{_gib(peak)} above the {_gib(held)} held before; {launches} photometric "
              f"launches | {card}")
        out[arch] = {"launches": launches, "stem_launches": stem, "steps": state.step,
                     "img_per_s": steady,
                     "peak_bytes": peak, "held_bytes": held, "gflop_forward": fwd}
        del trainer, state, metrics, idx_mat
    return out


# the train view of the transform phase: the shipped pair and crop, then
# every random op of the slice
TRANSFORM_VIEW = {
    "color_jitter": {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4, "hue": 0.1,
                     "apply_prob": 0.8},
    "random_gray": {"p": 0.2},
    "random_resized_crop": {"size": [32, 32], "scale": [0.2, 1.0]},
    "random_flip": None,
    "gaussian_blur": {"apply_prob": 0.5},
    "rand_aug": {"n_aug": 2},
    "cutout": {"n_cuts": 1, "max_len": 8},
    "to_tensor": None,
    "normalize": {"mean": [0.4914, 0.4822, 0.4465], "std": [0.247, 0.2435, 0.2616]},
}
EXACT_OPS = ("solarize", "posterize", "equalize")


def _transform_cases(B: int, g: torch.Generator) -> tuple[dict, dict]:
    """The slice's ops as functions of (images, draws), and their draws for B
    images from the host generator `g`: each random op given its draws, each
    of RandAugment's 14 branches at magnitudes from its range."""
    from ssv_tpu_torch.data import augment as A

    n_aug = 4
    draws = {"sigma": 0.1 + 1.9 * torch.rand(B, generator=g),
             "i": torch.randint(0, 9, (B,), generator=g),
             "j": torch.randint(0, 9, (B,), generator=g),
             "cut_len": torch.randint(1, 17, (B,), generator=g),
             "xs": torch.randint(0, 33, (B, 1, 2), generator=g),
             "choice": torch.randint(0, 14, (n_aug, B), generator=g),
             "u": torch.rand(n_aug, B, generator=g),
             "sign": torch.where(torch.rand(n_aug, B, generator=g) > 0.5, -1.0, 1.0)}
    cases = {"gaussian_blur": lambda x, d: A.gaussian_blur_sigma(x, d["sigma"]),
             "random_crop": lambda x, d: A.random_crop_at(x, d["i"], d["j"], 32, 4),
             "resize_24": lambda x, d: A.resize(x, 24),
             "resize_40": lambda x, d: A.resize(x, 40),
             "cutout": lambda x, d: A.cutout_at(x, d["cut_len"], d["xs"], 1),
             "rand_augment": lambda x, d: A.rand_augment_apply(x, d["choice"], d["u"],
                                                               d["sign"])}
    for c, (name, lo, hi, signed, fn) in enumerate(A.RANDAUG_OPS):
        v = lo + (hi - lo) * torch.rand(B, generator=g)
        draws[f"v{c}"] = v * torch.where(torch.rand(B, generator=g) > 0.5, -1.0, 1.0) \
            if signed else v
        cases[name] = lambda x, d, fn=fn, c=c: fn(x, d[f"v{c}"])
    return cases, draws


def phase_transforms(card: str) -> dict:
    """Every op of the slice on a B = 512 batch of the train split, on the
    card and on the CPU from the same draws: exact for solarize, posterize
    and equalize, within 1e-5 for the rest; each timed in ms per batch by
    CUDA events on the card (the random ops through their wrappers, which
    draw on the card). Then 10 SimCLR ResNet-18 steps through the Trainer
    with a train view that runs every random op of the slice after the
    fused pair (20 photometric launches)."""
    import yaml

    from ssv_tpu_torch.data import augment as A
    from ssv_tpu_torch.tools.measure import times_ms
    from ssv_tpu_torch.train.trainer import STEADY_AFTER, Trainer

    held = _held_before_run("transforms")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(HERE, "configs", "simclr.yaml")) as f:
            cfg = yaml.safe_load(f)
        cfg["data"]["transforms"]["train"] = TRANSFORM_VIEW
        path = os.path.join(tmp, "simclr.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
        trainer = Trainer({"config": path, "algo": "simclr", "arch": "resnet18",
                           "task": "train", "output": os.path.join(tmp, "run")})
        images, _ = trainer.pipeline.arrays("train")
        x = A.to_float(images[:512])
        cases, draws = _transform_cases(512, torch.Generator().manual_seed(0))
        gd = {k: v.cuda() for k, v in draws.items()}
        gen = torch.Generator(device="cuda").manual_seed(0)
        wrappers = {"gaussian_blur": lambda: A.gaussian_blur(gen, x),
                    "random_crop": lambda: A.random_crop(gen, x, 32, 4),
                    "cutout": lambda: A.cutout(gen, x, 1, 16),
                    "rand_augment": lambda: A.rand_augment(gen, x, 4)}
        ops = {}
        for name, fn in cases.items():
            got = fn(x, gd)
            want = fn(x.cpu(), draws)
            err = (got.cpu() - want).abs().max().item()
            exact = name in EXACT_OPS
            if not torch.isfinite(got).all() or err > (0.0 if exact else 1e-5):
                raise AssertionError(f"transform {name}: card against CPU max |diff| {err}")
            ms = statistics.median(times_ms(wrappers.get(name, lambda fn=fn: fn(x, gd))))
            ops[name] = {"max_abs_err": err, "ms": ms, "shape": list(got.shape)}
            print(f"[transforms] {name} B=512 {tuple(x.shape[1:3])} -> {tuple(got.shape[1:3])}: "
                  f"card against CPU max |diff| {err:.3e} ({'exact' if exact else 'tol 1e-5'}); "
                  f"{ms:.4f} ms a batch (CUDA events, median) | {card}")
        del x, gd
        idx_mat = trainer.pipeline.epoch_indices(trainer.generator)[:10]
        _reset_launches()
        state, metrics, steady = trainer._run_epoch(trainer.state, idx_mat)
        launches, stem = _launches(), _stem_launches()
        _check_mode("transforms", trainer.epoch_mode)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        losses = metrics["loss"].tolist()
        _check_launches("simclr", launches, state.step)
        _check_stem("simclr", state.model, stem, state.step)
        if state.step != 10 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"transforms: {state.step} steps, losses {losses}")
        print(f"[transforms] simclr resnet18 batch {trainer.pipeline.batch_size} with "
              f"{', '.join(TRANSFORM_VIEW)}: 10 steps, loss first {losses[0]:.4f} last "
              f"{losses[-1]:.4f}; {steady:.1f} img/s (steps {STEADY_AFTER + 1}-10), peak "
              f"memory {_gib(peak)} above the {_gib(held)} held before; {launches} "
              f"photometric launches | {card}")
        del trainer, state, metrics, idx_mat
    return {"launches": launches, "stem_launches": stem, "img_per_s": steady,
            "peak_bytes": peak, "ops": ops}


class Interrupt(Exception):
    """Raised by a `pre_epoch` hook to stop a run after epoch 1."""


def _interrupted_and_resumed(name: str, tmp: str, card: str, arch: str = "resnet18",
                             target: str = "target", at_start=None, at_stop=None,
                             at_resume=None, **overrides) -> dict:
    """configs/<name>.yaml, cut to 2 epochs with an eval each, through the
    CLI: stopped at the start of epoch 2 by an exception that `train_safe`
    sees (after it saved `latest`), then resumed with `-l`. Checks that the
    EMA target, key tower, teacher, bank or pseudo-labels
    (`state.extra[target]`: its parameters, else its buffers) moved in epoch
    1. `at_start(state)` runs at epoch 1's start, `at_stop(state, trainer,
    target as it was at epoch 1's start)` at the stop, `at_resume(state,
    what at_stop returned)` at the resumed run's first epoch start; what they
    return comes back under those names."""
    from ssv_tpu_torch import main as cli

    first = {}

    def stop_after_epoch_1(pre_epoch):
        def hook(state, trainer, epoch):
            module = state.extra[target]
            params = list(module.parameters()) or list(module.buffers())
            if epoch == 1:
                first["target"] = [p.detach().clone() for p in params]
                if at_start is not None:
                    first["at_start"] = at_start(state)
                return pre_epoch(state, trainer, epoch)
            first["stats"] = list(trainer.epoch_stats)
            before = first.pop("target")
            first["target_moved"] = max((p - q).abs().max().item()
                                        for p, q in zip(params, before))
            if at_stop is not None:
                first["at_stop"] = at_stop(state, trainer, before)
            del before
            raise Interrupt
        return hook

    run = os.path.join(tmp, "run")
    argv = ["-c", _config(tmp, name, epochs=2, eval_every=1, **overrides),
            "-m", arch, "-a", name]
    def check_resume(pre_epoch):
        def hook(state, trainer, epoch):
            if "at_resume" not in first:
                first["at_resume"] = at_resume(state, first.get("at_stop"))
            return pre_epoch(state, trainer, epoch)
        return hook

    held = [_held_before_run(f"{name} epoch 1")]
    _reset_launches()
    with _Hooks(pre_epoch=stop_after_epoch_1):
        try:
            cli.main([*argv, "-t", "train", "-o", run])
        except Interrupt:
            pass
        else:
            raise AssertionError(f"{name}: the run was not interrupted at epoch 2")
    saved = [n for n in ("latest", "best_model") if os.path.isfile(os.path.join(run, n))]
    if saved != ["latest", "best_model"] or not first["target_moved"] > 0:
        raise AssertionError(f"{name} after the interrupt: checkpoints {saved}, the "
                             f"target moved {first['target_moved']}")
    first_peak = torch.cuda.max_memory_allocated() - held[0]

    held.append(_held_before_run(f"{name} resumed"))
    with _Hooks(**({"pre_epoch": check_resume} if at_resume is not None else {})):
        resumed = cli.main([*argv, "-t", "train", "-o", run, "-l", run])
    launches = _launches()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held[1]

    stats = first["stats"] + resumed.epoch_stats
    steps = resumed.state.step
    _check_launches(name, launches, steps)
    stem = _epoch_stem(name, resumed.state.model, stats)
    attention = _epoch_attention(name, resumed.state.model, stats)
    if [e["epoch"] for e in stats] != [1, 2] or steps != sum(e["steps"] for e in stats):
        raise AssertionError(f"{name}: epochs {[e['epoch'] for e in stats]}, {steps} steps")
    losses = _check_losses(name, stats)
    print(f"[{name}] {arch} batch {resumed.pipeline.batch_size}: epoch 1 interrupted at "
          f"epoch 2's start, `latest` and `best_model` saved, the target moved by up to "
          f"{first['target_moved']:.3e}; resumed at epoch {resumed.epoch_stats[0]['epoch']}; "
          f"{steps} steps in all, loss first {losses[0]:.4f} last {losses[-1]:.4f}, "
          f"KNN {resumed.best_metric:.4f}")
    print(f"[{name}] steady-state {stats[0]['steady_img_per_s']:.1f} img/s (epoch 1) and "
          f"{stats[1]['steady_img_per_s']:.1f} img/s (epoch 2); peak memory of each run "
          f"above what was held before it {_gib(first_peak)} (epoch 1 and its KNN eval) "
          f"and {_gib(peak)} (resume, epoch 2, KNN, the probe); {launches} photometric "
          f"launches for {steps} steps ({launches / steps:g} a step), {attention} attention "
          f"launches | {card}")
    probe = _check_probe(f"{name} train", resumed, card)
    return {"launches": launches, "stem_launches": stem, "attention_launches": attention,
            "steps": steps,
            "peak_bytes": [first_peak, peak],
            "held_bytes": held, "img_per_s": [e["steady_img_per_s"] for e in stats],
            "linear_eval": probe, "argv": argv, "run": run, "resumed": resumed,
            "at_start": first.get("at_start"), "at_stop": first.get("at_stop"),
            "at_resume": first.get("at_resume")}


def phase_byol(card: str) -> dict:
    """BYOL ResNet-18 from configs/byol.yaml, cut to 2 epochs, through the
    CLI: interrupted and resumed, then `linear_eval -l` and
    `get_features -l`."""
    import numpy as np

    from ssv_tpu_torch import main as cli

    with tempfile.TemporaryDirectory() as tmp:
        out = _interrupted_and_resumed("byol", tmp, card)
        resumed = out.pop("resumed")
        n_train, n_test = resumed.pipeline.n_train, resumed.pipeline.n_test
        dim = int(resumed.config["proj_dim"])
        del resumed
        argv, run = out.pop("argv"), out.pop("run")
        out["held_bytes"].append(_held_before_run("byol -t linear_eval"))
        lin = cli.main([*argv, "-t", "linear_eval", "-o", os.path.join(tmp, "lin"),
                        "-l", run])
        out["linear_eval_task"] = _check_probe("byol -t linear_eval", lin, card)
        del lin
        feat_dir = os.path.join(tmp, "feat")
        out["held_bytes"].append(_held_before_run("byol -t get_features"))
        cli.main([*argv, "-t", "get_features", "-o", feat_dir, "-l", run])
        shapes = {n: np.load(os.path.join(feat_dir, f"{n}.npy")).shape
                  for n in ("train_fvecs", "train_gt", "test_fvecs", "test_gt")}
    want = {"train_fvecs": (n_train, dim), "train_gt": (n_train,),
            "test_fvecs": (n_test, dim), "test_gt": (n_test,)}
    if shapes != want:
        raise AssertionError(f"get_features wrote {shapes}, expected {want}")
    print(f"[byol] get_features: {shapes}")
    return out


def phase_family(card: str) -> dict:
    """SimSiam, ReLIC and Barlow Twins ResNet-18 from their shipped configs,
    10 train steps each through the Trainer. Returns the launches of each."""
    from ssv_tpu_torch.train.trainer import STEADY_AFTER, Trainer

    out = {}
    for name in ("simsiam", "relic", "barlow"):
        held = _held_before_run(name)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer({"config": os.path.join(HERE, "configs", f"{name}.yaml"),
                               "algo": name, "arch": "resnet18", "task": "train",
                               "output": os.path.join(tmp, "run")})
            idx_mat = trainer.pipeline.epoch_indices(trainer.generator)[:10]
            target = trainer.state.extra.get("target")
            before = [p.detach().clone() for p in target.parameters()] if target else []
            _reset_launches()
            state, metrics, steady = trainer._run_epoch(trainer.state, idx_mat)
            launches, stem = _launches(), _stem_launches()
            _check_mode(name, trainer.epoch_mode)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
        losses = metrics["loss"].tolist()
        _check_launches(name, launches, state.step)
        _check_stem(name, state.model, stem, state.step)
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
        out[name] = {"launches": launches, "stem_launches": stem, "steps": state.step,
                     "img_per_s": steady, "peak_bytes": peak, "held_bytes": held}
        del trainer, state, target, before, metrics, idx_mat
    return out


def phase_moco(card: str) -> dict:
    """MoCo ResNet-18 from configs/moco.yaml (batch 256, queue 1000, m
    0.999), cut to 2 epochs, interrupted and resumed through the CLI: the
    queue's pointer after the resume is (steps x 256) mod 1000."""
    with tempfile.TemporaryDirectory() as tmp:
        out = _interrupted_and_resumed("moco", tmp, card)
        resumed = out.pop("resumed")
        del out["argv"], out["run"]
        queue = resumed.state.extra["queue"]
        ptr, size = int(queue.ptr), queue.data.shape[0]
        batch, steps = resumed.pipeline.batch_size, out["steps"]
        zero_rows = int((queue.data.abs().sum(dim=1) == 0).sum())
        del resumed, queue
    if ptr != (steps * batch) % size or zero_rows:
        raise AssertionError(f"moco: queue pointer {ptr} after {steps} steps of {batch} "
                             f"(expected {(steps * batch) % size}), {zero_rows} zero rows")
    print(f"[moco] queue of {size}: pointer {ptr} = ({steps} x {batch}) mod {size} after "
          f"the resume, no zero row")
    out["queue_ptr"] = ptr
    return out


def phase_swav(card: str) -> dict:
    """SwAV ResNet-18 from configs/swav.yaml (batch 512, 3000 prototypes,
    3000 bank rows, hidden 512) for one epoch through the CLI, with KNN and
    the probe: `pre_train` leaves no zero row in the bank."""
    from ssv_tpu_torch import main as cli
    from ssv_tpu_torch.train.trainer import STEADY_AFTER

    seen = {}

    def check_bank(pre_train):
        def hook(state, trainer):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = pre_train(state, trainer)
            torch.cuda.synchronize()
            seen["seconds"] = time.perf_counter() - t0
            bank = state.extra["bank"].data
            seen["zero_rows"] = int((bank.abs().sum(dim=1) == 0).sum())
            seen["rows"] = bank.shape[0]
            seen["launches"] = _launches()
            return state
        return hook

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["-c", _config(tmp, "swav", epochs=1, eval_every=1), "-m", "resnet18",
                "-a", "swav", "-t", "train", "-o", os.path.join(tmp, "run")]
        held = _held_before_run("swav")
        _reset_launches()
        with _Hooks(pre_train=check_bank):
            trainer = cli.main(argv)
        launches = _launches()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    stats = trainer.epoch_stats
    steps = trainer.state.step
    _check_launches("swav", launches, steps)
    stem = _epoch_stem("swav", trainer.state.model, stats)
    losses = _check_losses("swav", stats)
    if seen.get("zero_rows") != 0 or seen.get("launches") != 0:
        raise AssertionError(f"swav: after pre_train {seen}")
    print(f"[swav] resnet18 batch {trainer.pipeline.batch_size}: pre_train filled all "
          f"{seen['rows']} bank rows from the train split's features in "
          f"{seen['seconds']:.2f} s (no zero row, no kernel launch); {steps} steps, loss "
          f"first {losses[0]:.4f} last {losses[-1]:.4f}, all finite, KNN "
          f"{trainer.best_metric:.4f}")
    print(f"[swav] steady-state {stats[0]['steady_img_per_s']:.1f} img/s (steps "
          f"{STEADY_AFTER + 1}-{steps}), peak memory {_gib(peak)} above the {_gib(held)} "
          f"held before; {launches} photometric launches | {card}")
    probe = _check_probe("swav", trainer, card)
    return {"launches": launches, "stem_launches": stem, "steps": steps,
            "img_per_s": stats[0]["steady_img_per_s"], "peak_bytes": peak, "held_bytes": held, "pre_train_seconds": seen["seconds"],
            "linear_eval": probe}


def phase_sela(card: str) -> dict:
    """SeLA ResNet-18 from configs/sela.yaml (batch 500, 10 heads of 128
    clusters, lambda 25, multistep), cut to 2 epochs through the CLI:
    relabelling epochs {0, 1}, so two sweeps run (`pre_train` and epoch 1's
    start), each timed; the pseudo-labels use more than one cluster. The run
    has `SSV_TPU_PROFILE_DIR` set: `_check_trace` reads the trace of epoch
    2."""
    from ssv_tpu_torch import main as cli
    from ssv_tpu_torch.train.trainer import STEADY_AFTER

    sweeps = []

    def timed(self_label):
        def hook(state, trainer):
            torch.cuda.synchronize()
            t0, launches = time.perf_counter(), _launches()
            state = self_label(state, trainer)
            torch.cuda.synchronize()
            labels = state.extra["self_label"].pseudo_labels
            sweeps.append({"seconds": time.perf_counter() - t0,
                           "launches": _launches() - launches,
                           "clusters": int(labels.unique().numel())})
            return state
        return hook

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["-c", _config(tmp, "sela", epochs=2, eval_every=1), "-m", "resnet18",
                "-a", "sela", "-t", "train", "-o", os.path.join(tmp, "run")]
        profile_dir = os.path.join(tmp, "profile")
        held = _held_before_run("sela")
        _reset_launches()
        os.environ["SSV_TPU_PROFILE_DIR"] = profile_dir
        try:
            with _Hooks(self_label=timed):
                trainer = cli.main(argv)
        finally:
            del os.environ["SSV_TPU_PROFILE_DIR"]
        launches = _launches()
        torch.cuda.synchronize()
        trace = _check_trace(profile_dir, trainer.epoch_stats[1]["steps"], card)
    peak = torch.cuda.max_memory_allocated() - held
    stats = trainer.epoch_stats
    steps = trainer.state.step
    _check_launches("sela", launches, steps)
    stem = _epoch_stem("sela", trainer.state.model, stats)
    losses = _check_losses("sela", stats)
    sl = trainer.state.extra["self_label"]
    clusters, best_head = int(sl.pseudo_labels.unique().numel()), int(sl.best_head)
    if trainer.algorithm.sl_epochs != {0, 1} or len(sweeps) != 2:
        raise AssertionError(f"sela: relabelling epochs {trainer.algorithm.sl_epochs}, "
                             f"{len(sweeps)} sweeps")
    if clusters <= 1 or any(s["launches"] for s in sweeps):
        raise AssertionError(f"sela: {clusters} clusters in use, sweeps {sweeps}")
    print(f"[sela] resnet18 batch {trainer.pipeline.batch_size}: 2 self-labelling sweeps of "
          f"the {trainer.pipeline.n_train} train images ("
          + ", ".join(f"{s['seconds']:.2f} s, {s['clusters']} clusters" for s in sweeps)
          + f"), no kernel launch in them; pseudo-labels use {clusters} of "
          f"{trainer.algorithm.num_clusters} clusters, best head {best_head}; {steps} "
          f"steps, loss first {losses[0]:.4f} last {losses[-1]:.4f}, KNN "
          f"{trainer.best_metric:.4f}")
    print(f"[sela] steady-state {stats[0]['steady_img_per_s']:.1f} img/s (epoch 1) and "
          f"{stats[1]['steady_img_per_s']:.1f} img/s (epoch 2), steps {STEADY_AFTER + 1} to "
          f"the end of each; peak memory {_gib(peak)} above the {_gib(held)} held before; "
          f"{launches} photometric launches for {steps} steps | {card}")
    probe = _check_probe("sela", trainer, card)
    return {"launches": launches, "stem_launches": stem, "steps": steps,
            "img_per_s": [e["steady_img_per_s"] for e in stats], "peak_bytes": peak,
            "held_bytes": held, "sweeps": sweeps, "clusters": clusters,
            "best_head": best_head, "linear_eval": probe, "trace": trace}


def _check_trace(profile_dir: str, steps: int, card: str) -> dict:
    """The profile hook's output: one Chrome trace, `epoch2.rank0.json`, with
    the span `epoch 2` and no other epoch's, a span `step <s>` for each of
    epoch 2's `steps` steps, and one photometric kernel on the device a step
    (SeLA's one augmented view), inside the epoch's span."""
    files = sorted(os.listdir(profile_dir))
    if files != ["epoch2.rank0.json"]:
        raise AssertionError(f"profile hook: wrote {files}, expected one trace of epoch 2")
    path = os.path.join(profile_dir, files[0])
    size = os.path.getsize(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    epochs = [e for e in spans if e["name"].startswith("epoch ")]
    step_names = {e["name"] for e in spans if e["name"].startswith("step ")}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "photometric_kernel" in e["name"]]
    if [e["name"] for e in epochs] != ["epoch 2"]:
        raise AssertionError(f"profile hook: epoch spans {[e['name'] for e in epochs]}")
    start, end = epochs[0]["ts"], epochs[0]["ts"] + epochs[0]["dur"]
    inside = sum(start <= k["ts"] <= end for k in kernels)
    print(f"[profile] SSV_TPU_PROFILE_DIR on the SeLA run: one trace {files[0]} "
          f"({size / 2**20:.1f} MiB, {len(events):,} spans and kernels); the span `epoch 2` "
          f"({epochs[0]['dur'] / 1e3:.1f} ms), {len(step_names)} step spans for {steps} "
          f"steps, {len(kernels)} photometric kernels on the device ({inside} inside the "
          f"epoch's span) | {card}")
    if step_names != {f"step {s}" for s in range(steps)}:
        raise AssertionError(f"profile hook: {len(step_names)} step spans for {steps} steps")
    if len(kernels) != LAUNCHES_PER_STEP["sela"] * steps or inside != len(kernels):
        raise AssertionError(f"profile hook: {len(kernels)} photometric kernels, {inside} "
                             f"inside epoch 2, for {steps} steps")
    return {"bytes": size, "events": len(events), "kernels": len(kernels),
            "epoch_ms": epochs[0]["dur"] / 1e3}


# DINO's ViT runs DINO_LAYERS of configs/dino.yaml's 6 layers here, at its
# widths: its 1,562 steps are the longest phase, and host-bound by their
# ops, which go with the depth
DINO_LAYERS = 2


def phase_dino(card: str) -> dict:
    """DINO on the ViT from configs/dino.yaml at its widths (hidden 384, 6
    heads, head 512 -> 1,024; batch 64, 2+2 global 32x32 and 6+6 local 8x8
    crops; adamw with the clamp and the decay ramp), cut to DINO_LAYERS
    layers and 2 epochs, interrupted and resumed through the CLI. At the stop, the
    teacher after epoch 1's EMA is lambda * (the teacher at epoch 1's start,
    which no step moves) + (1 - lambda) * (the student), lambda =
    cosine_ramp(1, epochs, 0.996, 1.0), to 1e-6; after the resume the
    center is not its randn draw, and the student's output, which the probe
    took, is 1,024 wide."""
    import numpy as np

    from ssv_tpu_torch.utils.schedules import cosine_ramp

    def center(state):
        return state.extra["center"].value.detach().clone()

    def ema_error(state, trainer, before):
        algo = trainer.algorithm
        lbd = cosine_ramp(1, algo.epochs, algo.lambda_lower, algo.lambda_upper)
        keep = float(np.float32(1) - np.float32(lbd))
        teacher = list(state.extra["teacher"].parameters())
        student = list(state.model.parameters())
        with torch.no_grad():
            err = max((t - (b * lbd + s * keep)).abs().max().item()
                      for t, b, s in zip(teacher, before, student))
            gap = math.sqrt(sum(float(((t - s) ** 2).sum()) for t, s in zip(teacher, student)))
            gap0 = math.sqrt(sum(float(((b - s) ** 2).sum()) for b, s in zip(before, student)))
        return {"lambda": lbd, "max_abs_err": err, "gap_ratio": gap / gap0}

    import yaml

    with open(os.path.join(HERE, "configs", "dino.yaml")) as f:
        encoder = {**yaml.safe_load(f)["encoder"], "num_encoder_layers": DINO_LAYERS}
    with tempfile.TemporaryDirectory() as tmp:
        out = _interrupted_and_resumed("dino", tmp, card, arch="vit", target="teacher",
                                       at_start=center, at_stop=ema_error, encoder=encoder)
        resumed = out.pop("resumed")
        del out["argv"], out["run"]
        c0 = out.pop("at_start")
        moved = (resumed.state.extra["center"].value - c0).abs().max().item()
        images, _ = resumed.pipeline.arrays("test")
        width = resumed.algorithm.embed(resumed.state,
                                        resumed._eval_t(None, images[:8])).shape[1]
        spe = resumed.pipeline.steps_per_epoch
        del resumed, images
    ema = out["at_stop"]
    print(f"[dino] teacher after epoch 1's EMA at lambda {ema['lambda']:.6f}: max |teacher - "
          f"(lambda teacher_0 + (1 - lambda) student)| = {ema['max_abs_err']:.3e}; "
          f"|teacher - student| / |teacher_0 - student| = {ema['gap_ratio']:.6f}; the center "
          f"moved by up to {moved:.3e} from its randn draw; the probe's input "
          f"{width} wide; {spe} steps an epoch")
    if not (ema["max_abs_err"] <= 1e-6 and abs(ema["gap_ratio"] - ema["lambda"]) <= 1e-4):
        raise AssertionError(f"dino: the teacher's EMA disagrees with lambda: {ema}")
    if not moved > 0 or width != 1024:
        raise AssertionError(f"dino: center moved {moved}, features {width} wide")
    out.update(center_moved=moved, ema=ema)
    return out


def phase_pirl(card: str) -> dict:
    """PIRL ResNet-18 from configs/pirl.yaml (batch 256, patches of 16, 4 a
    view, so 1,024 patch images a step; 1,000 negatives; bank momentum 0.5;
    proj 128), cut to 2 epochs, interrupted and resumed through the CLI:
    the bank after the resume equals the bank at the stop bit for bit; at
    the end exactly the rows epoch 2's batches touched differ from the bank
    at the stop, and every row is finite."""
    def bank_at_stop(state, trainer, before):
        return state.extra["bank"].data.cpu()

    def bank_restored(state, saved):
        return torch.equal(state.extra["bank"].data.cpu(), saved)

    with tempfile.TemporaryDirectory() as tmp:
        out = _interrupted_and_resumed("pirl", tmp, card, target="bank",
                                       at_stop=bank_at_stop, at_resume=bank_restored)
        resumed = out.pop("resumed")
        del out["argv"], out["run"]
        bank = resumed.state.extra["bank"].data.cpu()
        steps_2, batch = resumed.epoch_stats[0]["steps"], resumed.pipeline.batch_size
        n_patches = resumed.algorithm.num_patches
        del resumed
    saved = out.pop("at_stop")
    changed = int((bank != saved).any(dim=1).sum())
    finite = bool(torch.isfinite(bank).all())
    norms = bank.norm(dim=1)
    print(f"[pirl] bank {tuple(bank.shape)} float32: equal to the bank at the stop after the "
          f"resume: {out['at_resume']}; epoch 2 ({steps_2} steps of {batch}, {n_patches} "
          f"patches an image) changed {changed} rows; all rows finite: {finite}; row norms "
          f"{norms.min().item():.4f}-{norms.max().item():.4f}")
    if out["at_resume"] is not True or changed != steps_2 * batch or not finite:
        raise AssertionError(f"pirl: bank restored {out['at_resume']}, {changed} rows changed "
                             f"in epoch 2 (expected {steps_2 * batch}), finite {finite}")
    out.update(bank_rows_changed=changed)
    return out


class _Timed:
    """Times calls of `owner.<name>` for each (owner, name), the device
    synchronized before and after each call, restored on exit."""

    def __init__(self, *targets):
        self.targets = targets
        self.seconds = {name: [] for _, name in targets}

    def __enter__(self):
        self.saved = [(owner, name, getattr(owner, name)) for owner, name in self.targets]
        for owner, name, fn in self.saved:
            setattr(owner, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name].append(time.perf_counter() - t0)
            return out
        return timed

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)
        return False


def phase_deep_cluster(card: str) -> dict:
    """DeepCluster ResNet-18 from configs/deep_cluster.yaml (batch 512, 10
    classes, K-means 300 iterations x 10 restarts), cut to 2 epochs,
    interrupted and resumed through the CLI: the pseudo-labels after the
    resume equal those at the stop, and at the end they cover every train
    index with values in [0, 10). Prints the seconds of each epoch's
    `map_train` (features and predictions of the 50,000 train images),
    K-means and Hungarian step, host clock with the device synchronized."""
    from ssv_tpu_torch.train import trainer as trainer_mod
    from ssv_tpu_torch.train.algorithms import deep_cluster as dc_mod

    def labels_at_stop(state, trainer, before):
        return state.extra["pseudo_labels"].labels.cpu()

    def labels_restored(state, saved):
        return torch.equal(state.extra["pseudo_labels"].labels.cpu(), saved)

    with tempfile.TemporaryDirectory() as tmp, _Timed(
            (trainer_mod.Trainer, "map_train"), (dc_mod, "kmeans"),
            (dc_mod, "hungarian_match")) as timed:
        out = _interrupted_and_resumed("deep_cluster", tmp, card, target="pseudo_labels",
                                       at_stop=labels_at_stop, at_resume=labels_restored)
        resumed = out.pop("resumed")
        del out["argv"], out["run"]
        algo = resumed.algorithm
        labels = resumed.state.extra["pseudo_labels"].labels
        n_train, k = resumed.pipeline.n_train, algo.num_classes
        lo, hi, used = int(labels.min()), int(labels.max()), int(labels.unique().numel())
        feats_dim = int(resumed.config["linear_eval"]["input_dim"])
        km = (algo.kmeans_iters, algo.kmeans_redo)
        shape_ok = labels.shape == (n_train,)
        del resumed, algo, labels
    del out["at_stop"]
    secs = timed.seconds
    # float32 work of one K-means: per iteration one (N, d) x (d, R*K)
    # product to assign and one (R*K, N) x (N, d) to sum, 2 N d R K each
    flops = (2 * km[0] + 1) * 2 * n_train * feats_dim * km[1] * k
    bound_s = flops / 67e12
    print(f"[deep_cluster] pseudo-labels equal to those at the stop after the resume: "
          f"{out['at_resume']}; after epoch 2's clustering they cover {n_train} indices, "
          f"values {lo}-{hi}, {used} of {k} in use")
    for e in range(len(secs["kmeans"])):
        print(f"[deep_cluster] epoch {e + 1}: map_train {secs['map_train'][e]:.3f} s, K-means "
              f"{km[0]} x {km[1]} over {n_train} x {feats_dim} {secs['kmeans'][e]:.3f} s "
              f"(float32 bound {bound_s:.3f} s: {flops / 1e12:.2f} TFLOP at 67 TFLOP/s), "
              f"Hungarian {secs['hungarian_match'][e]:.4f} s | {card}")
    if out["at_resume"] is not True or not shape_ok or lo < 0 or hi >= k:
        raise AssertionError(f"deep_cluster: labels restored {out['at_resume']}, shape ok "
                             f"{shape_ok}, values {lo}-{hi} for {k} classes")
    if not len(secs["kmeans"]) == len(secs["map_train"]) == len(secs["hungarian_match"]) == 2:
        raise AssertionError(f"deep_cluster: expected one clustering an epoch: {secs}")
    out.update(seconds=secs, kmeans_bound_s=bound_s, labels_in_use=used)
    return out


# ----------------------------------------------------------------------
# the quality runner and the sweep
# ----------------------------------------------------------------------
class _Tee:
    """Writes to stdout and keeps a copy."""

    def __init__(self):
        self.out, self.lines = sys.stdout, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _strict_rows(text: str) -> list[dict]:
    """The JSON lines of a run's output, parsed strictly (NaN, Infinity and
    -Infinity refused)."""
    def refuse(name):
        raise AssertionError(f"a JSON line holds the bare constant {name}")

    return [json.loads(line, parse_constant=refuse)
            for line in text.splitlines() if line.startswith("{")]


def _quality_main(argv: list[str]) -> tuple[int, dict, str]:
    """`python -m ssv_tpu_torch.tools.quality_run <argv>` in this process:
    its exit code, its one row, parsed strictly, and its output."""
    import contextlib

    from ssv_tpu_torch.tools import quality_run

    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        rc = quality_run.main(argv)
    text = "".join(tee.lines)
    rows = _strict_rows(text)
    if len(rows) != 1:
        raise AssertionError(f"quality_run printed {len(rows)} JSON lines: {rows}")
    return rc, rows[0], text


QUALITY_EPOCHS = 2
SHAPES_EPOCHS = 2
SHAPES_SIZES = (8192, 2048)


def phase_quality(card: str) -> dict:
    """The quality runner through its entry point: SimCLR ResNet-18 from the
    shipped configs/simclr.yaml on synth100 at full size (50,000 / 10,000),
    QUALITY_EPOCHS epochs with a KNN each and the probe: the JSON line
    strict, one curve point an epoch, the probe's accuracy in (0, 1], 2
    photometric launches a step. Then SimCLR on `tiny` (synth100 at 5,120 /
    1,024) with epoch 1's parameters filled with NaN by a `pre_epoch` hook:
    `nan_at` 1, `linear` null, the probe never called."""
    from ssv_tpu_torch.train.trainer import Trainer

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        held = _held_before_run("quality simclr")
        _reset_launches()
        rc, row, _ = _quality_main(
            ["--algos", "simclr", "--epochs", str(QUALITY_EPOCHS), "--eval-every", "1",
             "--dataset", "synth100", "--set", f"linear_eval.epochs={PROBE_EPOCHS}",
             "--tag", "smoke", "--out", os.path.join(tmp, "smoke.md")])
        launches = _launches()
        peak = torch.cuda.max_memory_allocated() - held
        with open(os.path.join(tmp, "smoke.md")) as f:
            table = f.read()
    steps = QUALITY_EPOCHS * (50000 // 512)
    print(f"[quality] simclr resnet18 synth100 ({row.get('resolved_dataset')}): exit {rc}, "
          f"KNN curve {row.get('knn_curve')}, linear {row.get('linear')}, best epoch "
          f"{row.get('img_per_sec')} img/s (host clock), {row.get('wall_s')} s; {launches} "
          f"photometric launches for {steps} steps; peak memory {_gib(peak)} above the "
          f"{_gib(held)} held before | {card}")
    if rc != 0 or "error" in row:
        raise AssertionError(f"quality: exit {rc}, row {row}")
    if len(row["knn_curve"]) != QUALITY_EPOCHS or not 0.0 < row["linear"] <= 1.0:
        raise AssertionError(f"quality: curve {row['knn_curve']}, linear {row['linear']}")
    if "| simclr | 512 |" not in table:
        raise AssertionError(f"quality: the table holds no simclr row:\n{table}")
    _check_launches("simclr", launches, steps)
    out["main"] = {"launches": launches, "steps": steps, "row": row, "peak_bytes": peak}

    probes = []

    def nan_at_epoch_1(pre_epoch):
        def hook(state, trainer, epoch):
            if epoch == 1:
                with torch.no_grad():
                    for p in state.model.parameters():
                        p.fill_(float("nan"))
            return pre_epoch(state, trainer, epoch)
        return hook

    def counted(self):
        probes.append(1)
        return probe(self)

    probe = Trainer.perform_linear_eval
    with tempfile.TemporaryDirectory() as tmp:
        _held_before_run("quality nan")
        _reset_launches()
        Trainer.perform_linear_eval = counted
        try:
            with _Hooks(pre_epoch=nan_at_epoch_1):
                rc, row, _ = _quality_main(
                    ["--algos", "simclr", "--arch", "tiny", "--epochs", "2", "--eval-every",
                     "1", "--dataset", "synth100", "--n-train", "5120", "--n-test", "1024",
                     "--tag", "nan", "--out", os.path.join(tmp, "nan.md")])
        finally:
            Trainer.perform_linear_eval = probe
        nan_launches = _launches()
    print(f"[quality] simclr tiny with NaN parameters at epoch 1: exit {rc}, nan_at "
          f"{row.get('nan_at')}, KNN curve {row.get('knn_curve')}, linear {row.get('linear')}, "
          f"probe calls {len(probes)}, the JSON line strict; {nan_launches} photometric "
          f"launches")
    if rc != 0 or row.get("nan_at") != 1 or row.get("linear") is not None or probes:
        raise AssertionError(f"quality NaN case: exit {rc}, row {row}, {len(probes)} probes")
    _check_launches("simclr", nan_launches, 5120 // 512)
    out["nan"] = {"launches": nan_launches, "row": row}
    out["shapes100"] = _quality_shapes100(card)
    return out


def _quality_shapes100(card: str) -> dict:
    """A short shapes100 row through the runner's entry point (SwAV
    ResNet-18, configs/swav.yaml, SHAPES_EPOCHS epochs on SHAPES_SIZES, a
    KNN each), read back from its log by `python -m
    ssv_tpu_torch.tools.quality_parity --join swav <log> --keys-only`: the
    joined row's keys and curve whole, one graph captured over the row, 2
    photometric launches a step. Its quality is not judged."""
    import contextlib

    from ssv_tpu_torch.tools import quality_parity

    n_train, n_test = SHAPES_SIZES
    with tempfile.TemporaryDirectory() as tmp:
        held = _held_before_run("quality shapes100")
        _reset_launches()
        rc, row, text = _quality_main(
            ["--algos", "swav", "--epochs", str(SHAPES_EPOCHS), "--eval-every", "1",
             "--dataset", "shapes100", "--n-train", str(n_train), "--n-test", str(n_test),
             "--set", f"linear_eval.epochs={PROBE_EPOCHS}", "--tag", "shapes",
             "--out", os.path.join(tmp, "shapes.md")])
        launches = _launches()
        peak = torch.cuda.max_memory_allocated() - held
        log = os.path.join(tmp, "swav.log")
        with open(log, "w") as f:
            f.write(text)
        tee = _Tee()
        with contextlib.redirect_stdout(tee):
            parity_rc = quality_parity.main(["--join", "swav", log, "--eval-every", "1",
                                             "--keys-only"])
    joined = _strict_rows("".join(tee.lines))[0]
    steps = SHAPES_EPOCHS * (n_train // 512)
    captures = int(joined["diagnostics"]["rows"][-1][1])
    print(f"[quality] swav resnet18 shapes100 ({row.get('resolved_dataset')}): exit {rc}, "
          f"KNN curve {joined['knn_curve']}, linear {joined['linear']}, best epoch "
          f"{joined['img_per_sec']} img/s (host clock), {joined['wall_s']} s, {captures} "
          f"graph captured; the parity tool joined it whole (exit {parity_rc}); {launches} "
          f"photometric launches for {steps} steps; peak memory {_gib(peak)} above the "
          f"{_gib(held)} held before | {card}")
    if rc != 0 or parity_rc != 0 or "error" in row:
        raise AssertionError(f"quality shapes100: runner exit {rc}, tool exit {parity_rc}")
    if joined["n_train"] != n_train or captures != 1:
        raise AssertionError(f"quality shapes100: {joined['n_train']} images, {captures} "
                             "captures (1 expected)")
    _check_launches("swav", launches, steps)
    return {"launches": launches, "steps": steps, "row": joined, "peak_bytes": peak}


CIFAR_SIZES = (5 * 1024, 1024)   # the staged tarball's train (5 batches) and test images
CIFAR_TIMEOUT_S = 120            # the staging tool's limit


def _cifar_tarball(tmp: str) -> tuple[str, dict]:
    """A cifar-10-python.tar.gz in the published pickle layout from a numpy
    seed, and its arrays as the loader gives them (NHWC uint8, int32)."""
    import pickle
    import tarfile

    import numpy as np

    rs = np.random.RandomState(0)
    src = os.path.join(tmp, "src", "cifar-10-batches-py")
    os.makedirs(src)
    n_train, n_test = CIFAR_SIZES
    want = {}
    for split, names, n in (("train", [f"data_batch_{i}" for i in range(1, 6)], n_train // 5),
                            ("test", ["test_batch"], n_test)):
        xs, ys = [], []
        for name in names:
            data = rs.randint(0, 256, size=(n, 3072), dtype=np.uint8)
            labels = rs.randint(0, 10, n).tolist()
            with open(os.path.join(src, name), "wb") as f:
                pickle.dump({"data": data, "labels": labels}, f)
            xs.append(data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            ys.append(np.asarray(labels, np.int32))
        want[split] = (np.concatenate(xs), np.concatenate(ys))
    tar = os.path.join(tmp, "cifar-10-python.tar.gz")
    with tarfile.open(tar, "w:gz") as tf:
        tf.add(src, arcname="cifar-10-batches-py")
    return tar, want


def phase_cifar(card: str) -> dict:
    """Real-layout CIFAR-10 staged by the port's tool in its own process,
    then one SimCLR ResNet-18 epoch on it through the CLI from the cache."""
    import numpy as np
    import yaml

    from ssv_tpu_torch import main as cli

    with tempfile.TemporaryDirectory() as tmp:
        tar, want = _cifar_tarball(tmp)
        root = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ssv_tpu_torch.tools.fetch_cifar", "--dataset", "cifar10",
             "--root", root, "--from", tar], cwd=tmp, env=dict(os.environ, PYTHONPATH=HERE),
            capture_output=True, text=True, timeout=CIFAR_TIMEOUT_S)
        stage_s = time.perf_counter() - t0
        if proc.returncode != 0 or "staged cifar10" not in proc.stdout:
            raise AssertionError(f"cifar: fetch_cifar exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        caches = [os.path.join(root, f"cifar10_{split}.raw") for split in ("train", "test")]
        if not all(map(os.path.isfile, caches)):
            raise AssertionError(f"cifar: the tool wrote no .raw cache under {root}")
        stamps = [os.stat(c).st_mtime_ns for c in caches]
        # with the pickles gone, only the cache can give the staged images
        os.rename(os.path.join(root, "cifar-10-batches-py"), os.path.join(tmp, "moved"))

        cfg_path = _config(tmp, "simclr", epochs=1, eval_every=1)
        with open(cfg_path) as f:
            cfg = yaml.safe_load(f)
        cfg["data"]["root"] = root
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
        held = _held_before_run("cifar")
        _reset_launches()
        t0 = time.perf_counter()
        trainer = cli.main(["-c", cfg_path, "-m", "resnet18", "-a", "simclr", "-t", "train",
                            "-o", os.path.join(tmp, "run")])
        launches = _launches()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        rewritten = [os.stat(c).st_mtime_ns for c in caches] != stamps
    peak = torch.cuda.max_memory_allocated() - held
    ds = trainer.pipeline.dataset
    if ds.synthetic or ds.name != "cifar10" or rewritten:
        raise AssertionError(f"cifar: trained on {ds.name}, synthetic {ds.synthetic}, the "
                             f"cache rewritten {rewritten}")
    for split in ("train", "test"):
        got = getattr(ds, split)
        if not (np.array_equal(got.images, want[split][0])
                and np.array_equal(got.labels, want[split][1])):
            raise AssertionError(f"cifar: the {split} split is not the tarball's")
    stats = trainer.epoch_stats[-1]
    steps = stats["steps"]
    _check_launches("simclr", launches, steps)
    stem = _epoch_stem("simclr", trainer.state.model, [stats])
    losses = _check_losses("cifar", [stats])
    print(f"[cifar] fetch_cifar --from a {CIFAR_SIZES[0]:,} + {CIFAR_SIZES[1]:,}-image "
          f"tarball in its own process: {stage_s:.1f} s, .raw cache written; the pickles "
          f"moved away, the run's start read the cache (not rewritten): the tarball's "
          f"images and labels, not the synthetic fallback")
    print(f"[cifar] simclr resnet18 batch {trainer.pipeline.batch_size} on the staged "
          f"cifar10: {steps} steps in {train_s:.1f} s with the probe, loss first "
          f"{losses[0]:.4f} last {losses[-1]:.4f}, KNN {trainer.best_metric:.4f}, "
          f"{launches} photometric launches, peak memory {_gib(peak)} above the "
          f"{_gib(held)} held before | {card}")
    probe = _check_probe("cifar", trainer, card)
    return {"launches": launches, "stem_launches": stem, "steps": steps, "stage_s": stage_s,
            "train_s": train_s, "linear_eval": probe}


# the sweep's rows here: 2 epochs on half the tool's train split (5,120 /
# 1,024), since its DINO row alone takes about 64 s an epoch at 10,240
# (1,280 host-bound steps of batch 8)
SWEEP_EPOCHS = 2
SWEEP_SIZES = (5120, 1024)


def phase_sweep(card: str) -> dict:
    """The 12 rows of `python -m ssv_tpu_torch.tools.sweep` through its
    entry point, SWEEP_EPOCHS epochs each on SWEEP_SIZES, `--no-write`: no
    error row, finite
    losses, a KNN in [0, 1], the photometric launches per step of each
    algorithm; each row's img/s beside its committed floor (printed, not a
    gate: one call's host decides it)."""
    from ssv_tpu_torch.tools import sweep

    with tempfile.TemporaryDirectory() as tmp:
        results = os.path.join(tmp, "results.json")
        held = _held_before_run("sweep")
        _reset_launches()
        rc = sweep.main([str(SWEEP_EPOCHS), "--no-write", "--results", results,
                         "--n-train", str(SWEEP_SIZES[0]), "--n-test", str(SWEEP_SIZES[1]),
                         "--table", os.path.join(tmp, "table.md")])
        launches = _launches()
        peak = torch.cuda.max_memory_allocated() - held
        with open(results) as f:
            run = json.load(f)
    floors = sweep.load_floors()
    algo_of = {name: algo for name, algo, *_ in sweep.SWEEP}
    out = {}
    for r in run["results"]:
        name = r["algo"]
        if "error" in r:
            raise AssertionError(f"sweep row {name}: {r['error']}")
        floor = floors["floors"].get(name)
        ratio = f"{r['img_per_sec'] / floor:.3f} of its floor {floor:,}" if floor else "no floor"
        print(f"[sweep] {name} {r['arch']} batch {r['batch']}: losses {r['losses']}, KNN "
              f"{r['knn']}, best epoch {r['img_per_sec']:,} img/s ({ratio}), {r['wall_s']} s; "
              f"{r['photometric_launches']} photometric launches for {r['steps']} steps | {card}")
        if not all(map(math.isfinite, r["losses"])) or not 0.0 <= r["knn"] <= 1.0:
            raise AssertionError(f"sweep row {name}: {r}")
        _check_launches(algo_of[name], r["photometric_launches"], r["steps"])
        out[name] = r
    if rc != 0 or [r["algo"] for r in run["results"]] != [s[0] for s in sweep.SWEEP]:
        raise AssertionError(f"sweep: exit {rc}, rows {[r['algo'] for r in run['results']]}")
    print(f"[sweep] {len(out)} rows, {launches} photometric launches; floors from "
          f"{floors.get('card')}; peak memory {_gib(peak)} above the {_gib(held)} held before")
    return {"launches": launches, "rows": out}


# ----------------------------------------------------------------------
# data-parallel training across ranks
# ----------------------------------------------------------------------
DDP_TIMEOUT_S = 300     # each launch's limit, and each collective's wait
DDP_STEPS = 7           # bf16 steps of part (b), each mode (its img/s from step 6)
DDP_SIZES = (DDP_STEPS * 512, 1024)   # part (b)'s synthetic train and test images
DDP_F32_BATCH = 128     # global batch of part (b)'s float32 steps


def _simclr_f32(device):
    """SimCLR ResNet-18 at full width from configs/simclr.yaml in float32,
    its state from the seed-0 host generator, and the given views of its
    two steps (a numpy seed; no draws differ between runs)."""
    import numpy as np
    import yaml

    from ssv_tpu_torch.train.base import DataInfo
    from ssv_tpu_torch.train.registry import build_algorithm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(HERE, "configs", "simclr.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["compute_dtype"] = "float32"
    b = DDP_F32_BATCH
    algo = build_algorithm("simclr", cfg, "resnet18", DataInfo(10, 50000, b, 50000 // b), device)
    state = algo.init_state(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    views = [{k: torch.from_numpy(rs.randn(b, 32, 32, 3).astype(np.float32))
              for k in ("aug_1", "aug_2")} for _ in range(2)]
    return algo, state, views


def _ddp_collectives(device) -> dict:
    """Each collective the slice uses, on CUDA tensors, held to its value."""
    from ssv_tpu_torch.parallel import mesh, per_device

    w, r = mesh.world_size(), mesh.rank()
    checks = {}

    def check(name, fn):
        try:
            checks[name] = "ok" if fn() else "wrong value"
        except RuntimeError as err:   # a collective the backend does not carry
            checks[name] = f"{type(err).__name__}: {str(err).splitlines()[0][:160]}"

    def all_reduce():
        t = per_device.all_reduce_sum(torch.full((3,), r + 1.0, device=device))
        return torch.equal(t.cpu(), torch.full((3,), w * (w + 1) / 2))

    def gather_and_backward():
        x = torch.full((2, 3), float(r), device=device, requires_grad=True)
        g = per_device.pgather(x)
        c = torch.arange(g.numel(), dtype=torch.float32, device=device).reshape(g.shape)
        (g * c).sum().backward()
        want = torch.arange(w).repeat_interleave(2)[:, None].expand(-1, 3).float()
        return (torch.equal(g.detach().cpu(), want)
                and torch.equal(x.grad.cpu(), w * c[2 * r:2 * r + 2].cpu()))

    def broadcast():
        t = torch.full((4,), float(r), device=device)
        mesh.broadcast_([t])
        return torch.equal(t.cpu(), torch.zeros(4))

    def pmean():
        return float(per_device.pmean(torch.tensor(float(r), device=device))) == (w - 1) / 2

    check("all_reduce (sync BN, gradients, pmean)", all_reduce)
    check("all_gather and its backward (pgather)", gather_and_backward)
    check("broadcast (replicate, epoch indices)", broadcast)
    check("pmean", pmean)
    check("all_gather_object (checkpoint generators)",
          lambda: mesh.gather_objects(r) == list(range(w)))
    check("broadcast_object_list (output name)", lambda: mesh.broadcast_object(r) == 0)
    check("barrier", lambda: mesh.barrier() is None)
    return checks


def _ddp_trainer_steps(cfg_path: str, out_dir: str, device) -> dict:
    """DDP_STEPS steps of the `Trainer` on the epoch's first rows."""
    from ssv_tpu_torch.parallel.dryrun import digest
    from ssv_tpu_torch.train.trainer import Trainer

    trainer = Trainer({"config": cfg_path, "algo": "simclr", "arch": "resnet18",
                       "task": "train", "output": out_dir}, device=device,
                      synthetic_sizes=DDP_SIZES)
    idx_mat = trainer.epoch_indices()[:DDP_STEPS]
    _reset_launches()
    state, metrics, steady = trainer._run_epoch(trainer.state, idx_mat)
    launches = _launches()
    out = {"losses": metrics["loss"].tolist(), "launches": launches, "img_per_s": steady,
           "per_rank_batch": idx_mat.shape[1] // 2,
           "digest": digest(state.model, *state.extra.values())}
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ddp_rank(rank: int, tmp: str) -> None:
    """One of part (b)'s two ranks on the one card, over gloo."""
    from ssv_tpu_torch.parallel import mesh
    from ssv_tpu_torch.parallel.dryrun import digest

    device = mesh.init("cuda:0", backend="gloo", init_method=f"file://{tmp}/group",
                       rank=rank, world_size=2, timeout_s=DDP_TIMEOUT_S)
    try:
        out = {"collectives": _ddp_collectives(device)}
        if any(v != "ok" for v in out["collectives"].values()):
            raise RuntimeError(f"gloo on CUDA tensors: {out['collectives']}")
        algo, state, views = _simclr_f32(device)
        losses = []
        for batch in views:
            local = {k: mesh.batch_slice(v).to(device) for k, v in batch.items()}
            state, m = algo.train_step(state, local)
            losses.append(m["loss"].item())
        out["f32"] = {"losses": losses, "digest": digest(state.model),
                      "state": {k: v.cpu() for k, v in state.model.state_dict().items()}}
        del algo, state
        out["bf16"] = {mode: _ddp_trainer_steps(os.path.join(tmp, f"{mode}.yaml"),
                                                os.path.join(tmp, f"run-{mode}"), device)
                       for mode in ("sync", "per_device_bn")}
    finally:
        mesh.destroy()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def phase_ddp(card: str, slice_out: dict) -> dict:
    """Data-parallel training across ranks on the one card.

    (a) one rank over NCCL through torchrun: SimCLR ResNet-18 from
    configs/simclr.yaml, one epoch, `python -m ssv_tpu_torch.main` as a user
    runs it; its per-step losses against phase 3's, its img/s beside phase
    3's, 2 photometric launches a step.
    (b) two ranks on the one card over gloo (NCCL refuses two ranks on one
    device): every collective the slice uses, on CUDA tensors; two float32
    steps at full width on given views against the one-process step
    (params 1e-4, BN statistics 1e-5); DDP_STEPS bf16 steps of the Trainer
    at global batch 512 (256 a rank), sync BN and then `per_device_bn`:
    finite losses, the state bit for bit the same on both ranks, 2 launches
    a step at B = 256. Two ranks sharing one card give no scaling figure.
    Then the photometric wrapper on a tensor of a device that is not the
    current one, where the machine has a second device."""
    import torch.multiprocessing as mp

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a): the probe cut to one epoch (this part checks the steps)
        cfg_path = _config(tmp, "simclr", probe_epochs=1, epochs=1, eval_every=1)
        run_dir = os.path.join(tmp, "torchrun")
        env = dict(os.environ, PYTHONPATH=HERE)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "ssv_tpu_torch.main", "-c", cfg_path,
               "-m", "resnet18", "-a", "simclr", "-t", "train", "-o", run_dir]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True,
                              timeout=DDP_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"ddp (a): torchrun exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(os.path.join(run_dir, "epoch_stats.jsonl")) as f:
            stats = json.loads(f.readline())
        losses = _check_losses("ddp", [stats])
        _check_launches("simclr", stats["photometric_launches"], stats["steps"])
        diff = max(abs(a - b) for a, b in zip(losses, slice_out["losses"]))
        print(f"[ddp] (a) torchrun, 1 rank over NCCL: {stats['steps']} steps in "
              f"{time.perf_counter() - t0:.1f} s, steady {stats['steady_img_per_s']:.1f} img/s "
              f"(phase 3 in this call {slice_out['img_per_s']:.1f}), per-step losses "
              f"within {diff:.3e} of phase 3's, {stats['photometric_launches']} photometric "
              f"launches | {card}")
        out["a"] = {"img_per_s": stats["steady_img_per_s"], "loss_diff": diff,
                    "launches": stats["photometric_launches"], "steps": stats["steps"]}

        # (b): the one-process float32 reference first, then the two ranks
        algo, state, views = _simclr_f32("cuda")
        ref_losses = []
        for batch in views:
            state, m = algo.train_step(state, {k: v.cuda() for k, v in batch.items()})
            ref_losses.append(m["loss"].item())
        ref = {k: v.cpu() for k, v in state.model.state_dict().items()}
        del algo, state
        for mode in ("sync", "per_device_bn"):
            _config(tmp, "simclr", epochs=1, per_device_bn=mode != "sync")
            os.replace(os.path.join(tmp, "simclr.yaml"), os.path.join(tmp, f"{mode}.yaml"))
        t0 = time.perf_counter()
        ctx = mp.start_processes(_ddp_rank, args=(tmp,), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + DDP_TIMEOUT_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"ddp (b): the ranks did not end in {DDP_TIMEOUT_S} s")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
                 for r in range(2)]
        seconds_b = time.perf_counter() - t0
    for name, verdict in ranks[0]["collectives"].items():
        print(f"[ddp] (b) gloo on CUDA tensors, 2 ranks: {name}: {verdict}")
    param_err = max((ranks[0]["f32"]["state"][k].float() - v.float()).abs().max().item()
                    for k, v in ref.items() if k.endswith(("weight", "bias")))
    stat_err = max((ranks[0]["f32"]["state"][k] - v).abs().max().item()
                   for k, v in ref.items() if k.endswith(("running_mean", "running_var")))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["f32"]["losses"], ref_losses))
    print(f"[ddp] (b) float32 sync steps at 2 ranks against one process, global batch "
          f"{DDP_F32_BATCH}: params within {param_err:.3e}, BN statistics {stat_err:.3e}, "
          f"losses {loss_err:.3e} relative")
    if param_err > 1e-4 or stat_err > 1e-5 or loss_err > 1e-5:
        raise AssertionError("ddp (b): the 2-rank float32 step differs from one process's")
    if ranks[0]["f32"]["digest"] != ranks[1]["f32"]["digest"]:
        raise AssertionError("ddp (b): the ranks' float32 states differ")
    out["b"] = {"f32_param_err": param_err, "f32_stat_err": stat_err, "seconds": seconds_b}
    for mode in ("sync", "per_device_bn"):
        r0, r1 = ranks[0]["bf16"][mode], ranks[1]["bf16"][mode]
        if not all(map(math.isfinite, r0["losses"] + r1["losses"])):
            raise AssertionError(f"ddp (b) {mode}: non-finite losses")
        if r0["digest"] != r1["digest"] or r0["losses"] != r1["losses"]:
            raise AssertionError(f"ddp (b) {mode}: the ranks' states differ")
        for r in (r0, r1):
            if r["launches"] != 2 * DDP_STEPS:
                raise AssertionError(f"ddp (b) {mode}: {r['launches']} photometric launches "
                                     f"for {DDP_STEPS} steps, expected {2 * DDP_STEPS}")
        print(f"[ddp] (b) bf16 {mode}, 2 ranks sharing the card, batch {r0['per_rank_batch']} "
              f"a rank: {DDP_STEPS} steps, loss first {r0['losses'][0]:.4f} last "
              f"{r0['losses'][-1]:.4f}, the state bit for bit the same on both ranks, "
              f"{r0['launches']} launches a rank, {r0['img_per_s']:.1f} img/s (two ranks on "
              f"one card: not a scaling figure) | {card}")
        out["b"][mode] = {"img_per_s": r0["img_per_s"], "launches": r0["launches"] + r1["launches"]}
    _check_device_repair()
    return out


# ----------------------------------------------------------------------
# the model axis: SwAV's prototype table sharded over a model group
# ----------------------------------------------------------------------
TP_STEPS = 8            # bf16 steps of part (a) (the second half timed)
TP_TIMEOUT_S = 400      # each spawn's limit, and each collective's wait


def _swav_f32(device):
    """SwAV ResNet-18 at configs/swav.yaml's widths (batch 512, hidden 512,
    proj 128, 3000 prototypes, bank 3000) in float32, SGD at lr 0.1 from the
    first step (the dry run's: the shipped 2.0 without its warmup makes two
    steps chaotic, and with it the first lr is 1e-12), its state from the
    seed-0 host generator, the bank filled with unit rows and the given
    views of two steps from a numpy seed: the same in every process."""
    import numpy as np
    import yaml

    from ssv_tpu_torch.objectives.losses import l2_normalize
    from ssv_tpu_torch.state.banks import ring_push
    from ssv_tpu_torch.train.base import DataInfo
    from ssv_tpu_torch.train.registry import build_algorithm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(HERE, "configs", "swav.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(compute_dtype="float32", epochs=1,
               scheduler={"name": "cosine", "warmup_epochs": 0})
    cfg["optimizer"]["lr"] = 0.1
    b = cfg["data"]["batch_size"]
    algo = build_algorithm("swav", cfg, "resnet18", DataInfo(10, 50000, b, 50000 // b), device)
    state = algo.init_state(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    bank = rs.randn(cfg["feature_bank_size"], cfg["proj_dim"]).astype(np.float32)
    ring_push(state.extra["bank"], l2_normalize(torch.from_numpy(bank)).to(device))
    views = [{k: torch.from_numpy(rs.randn(b, 32, 32, 3).astype(np.float32))
              for k in ("aug_1", "aug_2")} for _ in range(2)]
    return algo, state, views


def _swav_bf16_steps(device) -> dict:
    """TP_STEPS bf16 SwAV steps from configs/swav.yaml on the synthetic
    CIFAR-10, each rank's batch drawn from a generator keyed by its data
    rank; the collectives, their bytes and host seconds a step."""
    import yaml

    from ssv_tpu_torch.data.pipeline import DataPipeline
    from ssv_tpu_torch.objectives.losses import l2_normalize
    from ssv_tpu_torch.parallel import batch_slice, mesh
    from ssv_tpu_torch.parallel.dryrun import digest
    from ssv_tpu_torch.state.banks import ring_push
    from ssv_tpu_torch.train.base import DataInfo
    from ssv_tpu_torch.train.registry import build_algorithm
    from ssv_tpu_torch.utils import trace

    with open(os.path.join(HERE, "configs", "swav.yaml")) as f:
        cfg = yaml.safe_load(f)
    b = cfg["data"]["batch_size"]
    pipeline = DataPipeline(cfg["data"], device, synthetic_sizes=(b * TP_STEPS, b))
    algo = build_algorithm("swav", cfg, "resnet18",
                           DataInfo(10, pipeline.n_train, b, TP_STEPS), device)
    state = algo.init_state(torch.Generator().manual_seed(0))
    rows = torch.randn(cfg["feature_bank_size"], cfg["proj_dim"],
                       generator=torch.Generator().manual_seed(1))
    ring_push(state.extra["bank"], l2_normalize(rows).to(device))
    images, labels = pipeline.arrays("train")
    batch_fn = pipeline.make_batch_fn("double")
    generator = torch.Generator(device=device).manual_seed(mesh.data_rank())
    idx_mat = torch.arange(b * TP_STEPS, device=device).reshape(TP_STEPS, b)
    losses = []
    _reset_launches()
    for s in range(TP_STEPS):
        if s == TP_STEPS // 2:       # the second half is timed
            torch.cuda.synchronize(device)
            before = {k: trace.counters.get(f"collectives.{k}", 0)
                      for k in ("calls", "bytes", "host_s")}
            t0 = time.perf_counter()
        state, m = algo.train_step(
            state, batch_fn(images, labels, batch_slice(idx_mat[s]), generator), generator)
        losses.append(m["loss"].item())
    torch.cuda.synchronize(device)
    timed = TP_STEPS - TP_STEPS // 2
    seconds = time.perf_counter() - t0
    coll = {k: trace.counters.get(f"collectives.{k}", 0) - v for k, v in before.items()}
    out = {"losses": losses, "launches": _launches(),
           "tower": digest(state.model.tower, state.extra["bank"]),
           "shard": digest(state.model.prototypes), "step_ms": 1e3 * seconds / timed,
           "collectives_per_step": coll["calls"] / timed,
           "mb_per_step": coll["bytes"] / timed / 1e6,
           "collective_ms_per_step": 1e3 * coll["host_s"] / timed,
           "shard_rows": state.model.prototypes.table.shape[0]}
    del algo, state, pipeline
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_rank(rank: int, world: int, part: str, tmp: str) -> None:
    """One rank on the one card over gloo: part "a" at (1 x 2), part "b" the
    dry run's DPxTP phase at 4 ranks."""
    from ssv_tpu_torch.parallel import batch_slice, dryrun, mesh

    device = mesh.init("cuda:0", backend="gloo", init_method=f"file://{tmp}/group-{part}",
                       rank=rank, world_size=world, timeout_s=TP_TIMEOUT_S,
                       model_parallel=2 if part == "a" else 1)
    try:
        if part == "a":
            algo, state, views = _swav_f32(device)
            losses = []
            for batch in views:
                state, m = algo.train_step(
                    state, {k: batch_slice(v).to(device) for k, v in batch.items()})
                losses.append(m["loss"].item())
            out = {"losses": losses,
                   "state": {k: v.cpu() for k, v in state.model.state_dict().items()}}
            del algo, state
            out["bf16"] = _swav_bf16_steps(device)
        else:
            _reset_launches()
            dryrun.phase_dp_tp_swav(device)
            out = {"launches": _launches()}
    finally:
        mesh.destroy()
    torch.save(out, os.path.join(tmp, f"{part}-rank{rank}.pt"))


def _spawn_ranks(world: int, part: str, tmp: str) -> list[dict]:
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_tp_rank, args=(world, part, tmp), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TP_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"tp ({part}): the ranks did not end in {TP_TIMEOUT_S} s")
    return [torch.load(os.path.join(tmp, f"{part}-rank{r}.pt"), weights_only=True)
            for r in range(world)]


def _cifar_binary_dir(root: str) -> dict:
    """A cifar-10-batches-bin directory at the real layout's size (5 train
    files of 10,000 rows, a test file of 10,000) from a numpy seed."""
    import numpy as np

    d = os.path.join(root, "cifar-10-batches-bin")
    os.makedirs(d)
    rs = np.random.RandomState(0)
    files = {}
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]:
        rows = rs.randint(0, 256, size=(10000, 1 + 3072)).astype(np.uint8)
        rows[:, 0] %= 10
        path = os.path.join(d, name)
        rows.tofile(path)
        files[name] = path
    return files


def _phase_native_io(card: str) -> dict:
    """(c): the native library built by g++ here, each binary file read by
    it and by its NumPy version (bit for bit), the pickle layout's repack
    likewise, then `load_dataset` twice: the first reads the binaries and
    writes the `.raw` cache, the second reads the cache."""
    import numpy as np

    from ssv_tpu_torch.data import datasets, native_io
    from ssv_tpu_torch.ops import build

    t0 = time.perf_counter()
    native_io.available()
    build_s = time.perf_counter() - t0
    out = {"build_s": build_s}
    with tempfile.TemporaryDirectory() as root:
        files = _cifar_binary_dir(root)
        native_s = numpy_s = 0.0
        for path in files.values():
            t0 = time.perf_counter()
            got = native_io.read_cifar_binary(path, 1, 10000)
            native_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            want = native_io.read_cifar_binary_numpy(path, 1, 10000)
            numpy_s += time.perf_counter() - t0
            if not all(np.array_equal(a, b) for a, b in zip(got, want)) or len(got[0]) != 10000:
                raise AssertionError(f"native IO: {path} differs from the NumPy reader")
        chw = np.ascontiguousarray(got[0].transpose(0, 3, 1, 2))
        t0 = time.perf_counter()
        hwc = native_io.chw_to_hwc(chw)
        repack_s = time.perf_counter() - t0
        if not np.array_equal(hwc, native_io.chw_to_hwc_numpy(chw)):
            raise AssertionError("native IO: chw_to_hwc differs from the NumPy repack")
        times, loads = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            loads.append(datasets.load_dataset("cifar10", root, allow_synthetic=False))
            times.append(time.perf_counter() - t0)
            ds = loads[-1]
            if ds.synthetic or ds.train.images.shape != (50000, 32, 32, 3):
                raise AssertionError(f"native IO: load_dataset gave {ds.train.images.shape}, "
                                     f"synthetic {ds.synthetic}")
        cache = os.path.join(root, "cifar10_train.raw")
        if not os.path.isfile(cache):
            raise AssertionError("native IO: the first load wrote no cache")
        for split in ("train", "test"):
            a, b = getattr(loads[0], split), getattr(loads[1], split)
            if not (np.array_equal(a.images, b.images) and np.array_equal(a.labels, b.labels)):
                raise AssertionError(f"native IO: the cache's {split} split differs")
        cache_mb = (os.path.getsize(cache)
                    + os.path.getsize(os.path.join(root, "cifar10_test.raw"))) / 1e6
    print(f"[tp] (c) native IO: {os.path.basename(str(build.library_path('ssv_io')))} built "
          f"by g++ in {build_s:.2f} s; 6 binary files of 10,000 rows: library "
          f"{native_s:.3f} s, NumPy {numpy_s:.3f} s, bit for bit; chw_to_hwc of 10,000 "
          f"images {1e3 * repack_s:.1f} ms, the same as NumPy's")
    print(f"[tp] (c) load_dataset cifar10, 50,000 + 10,000: first (binaries, writes a "
          f"{cache_mb:.1f} MB cache) {times[0]:.3f} s, second (the cache) {times[1]:.3f} s, "
          f"the same arrays | {card}")
    out.update(native_s=native_s, numpy_s=numpy_s, repack_s=repack_s, first_load_s=times[0],
               cached_load_s=times[1])
    return out


def phase_tp(card: str) -> dict:
    """The model axis on the one card (ranks sharing it over gloo, as NCCL
    refuses two ranks on one device).

    (a) SwAV ResNet-18 at configs/swav.yaml's widths on 2 ranks as data 1 x
    model 2, 1,500 prototype rows a rank: two float32 steps on given views
    against the one-process step (the loss 1e-5 relative, the gathered table
    and the tower: params 1e-4, BN statistics 1e-5); then TP_STEPS bf16
    steps: finite losses, the tower and the bank bit for bit the same on
    both ranks, the shards distinct, 2 photometric launches a step a rank at
    B = 512; the collectives a step, MB a step and host ms inside them.
    (b) the dry run's DPxTP phase at 4 ranks (2 x 2) on CUDA tensors.
    (c) the native IO library (`_phase_native_io`)."""
    out = {}
    algo, state, views = _swav_f32("cuda")
    global_batch = views[0]["aug_1"].shape[0]
    ref_losses = []
    for batch in views:
        state, m = algo.train_step(state, {k: v.cuda() for k, v in batch.items()})
        ref_losses.append(m["loss"].item())
    ref = {k: v.cpu() for k, v in state.model.state_dict().items()}
    del algo, state, views
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = _spawn_ranks(2, "a", tmp)
        seconds_a = time.perf_counter() - t0
        t0 = time.perf_counter()
        dry = _spawn_ranks(4, "b", tmp)
        seconds_b = time.perf_counter() - t0
    got = dict(ranks[0]["state"])
    got["prototypes.table"] = torch.cat([r["state"]["prototypes.table"] for r in ranks])
    param_err = max((got[k].float() - v.float()).abs().max().item()
                    for k, v in ref.items() if k.endswith(("weight", "bias", "table")))
    stat_err = max((got[k] - v).abs().max().item()
                   for k, v in ref.items() if k.endswith(("running_mean", "running_var")))
    table_err = (got["prototypes.table"] - ref["prototypes.table"]).abs().max().item()
    loss_err = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], ref_losses))
    print(f"[tp] (a) float32 SwAV ResNet-18 at 1 x 2 (data x model), "
          f"{got['prototypes.table'].shape[0]:,} prototypes, "
          f"{ranks[0]['state']['prototypes.table'].shape[0]:,} a rank, global batch "
          f"{global_batch}, two steps against one process: the gathered table within {table_err:.3e}, every "
          f"param {param_err:.3e}, BN statistics {stat_err:.3e}, losses {loss_err:.3e} "
          f"relative")
    if param_err > 1e-4 or stat_err > 1e-5 or loss_err > 1e-5:
        raise AssertionError("tp (a): the 1 x 2 float32 step differs from one process's")
    r0, r1 = ranks[0]["bf16"], ranks[1]["bf16"]
    if not all(map(math.isfinite, r0["losses"] + r1["losses"])):
        raise AssertionError("tp (a) bf16: non-finite losses")
    if r0["tower"] != r1["tower"] or r0["losses"] != r1["losses"]:
        raise AssertionError("tp (a) bf16: the ranks' towers, banks or losses differ")
    if r0["shard"] == r1["shard"]:
        raise AssertionError("tp (a) bf16: the two model ranks hold the same shard")
    for r in (r0, r1):
        if r["launches"] != 2 * TP_STEPS:
            raise AssertionError(f"tp (a) bf16: {r['launches']} photometric launches for "
                                 f"{TP_STEPS} steps, expected {2 * TP_STEPS}")
    print(f"[tp] (a) bf16, 2 ranks sharing the card at 1 x 2, batch {global_batch} on each: "
          f"{TP_STEPS} "
          f"steps, loss first {r0['losses'][0]:.4f} last {r0['losses'][-1]:.4f}, the tower "
          f"and bank bit for bit the same on both ranks, {r0['launches']} launches a rank; "
          f"{r0['step_ms']:.2f} ms a step, {r0['collectives_per_step']:.1f} collectives "
          f"{r0['mb_per_step']:.3f} MB and {r0['collective_ms_per_step']:.2f} host ms a step "
          f"on rank 0 (two ranks on one card: not a scaling figure) | {card}")
    print(f"[tp] (b) the dry run's DPxTP phase at 4 ranks (2 x 2) on CUDA tensors over gloo "
          f"passed in {seconds_b:.1f} s, {sum(d['launches'] for d in dry)} photometric "
          f"launches")
    out["a"] = {"table_err": table_err, "param_err": param_err, "stat_err": stat_err,
                "loss_err": loss_err, "seconds": seconds_a,
                "launches": r0["launches"] + r1["launches"],
                **{k: r0[k] for k in ("step_ms", "collectives_per_step", "mb_per_step",
                                      "collective_ms_per_step")}}
    out["b"] = {"seconds": seconds_b, "launches": sum(d["launches"] for d in dry)}
    if out["b"]["launches"] == 0:
        raise AssertionError("tp (b): the dry run's phase launched no photometric kernel")
    out["c"] = _phase_native_io(card)
    return out


def _check_device_repair() -> None:
    """The photometric wrapper launches on its tensors' device when another
    is current."""
    from ssv_tpu_torch.ops.photometric import fused_photometric, photometric_reference
    from ssv_tpu_torch.tools.measure import photometric_inputs

    if torch.cuda.device_count() < 2:
        print(f"[ddp] device repair: {torch.cuda.device_count()} CUDA device on this "
              f"machine, no device that is not the current one to launch on: not checked")
        return
    with torch.cuda.device(1):
        images, order, params, _ = photometric_inputs(
            64, 32, 32, torch.Generator(device="cuda:1").manual_seed(0))
    with torch.cuda.device(0):
        got = fused_photometric(images, order, params)
        want = photometric_reference(images, order, params)
        torch.cuda.synchronize(1)
    err = (got - want).abs().max().item()
    print(f"[ddp] device repair: launched on cuda:1 with cuda:0 current, max |kernel - plain| "
          f"= {err:.3e}")
    if err > TOL:
        raise AssertionError(f"photometric kernel on a non-current device: {err} > {TOL}")


def _timed(name: str, fn, *args):
    """fn(*args), its seconds printed under `name`."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> None:
    t0 = time.perf_counter()
    card = phase_env()
    _timed("build", phase_build)
    kernels = _timed("kernels", phase_kernels, card)
    _timed("small steps", phase_small_steps, ["simclr", "simclr-bottleneck", "simclr-tiny"])
    # each path's checked launches: the photometric kernel's, and the stem
    # kernels' where the path's train steps ran in this process
    paths, stem, attention = {}, {}, {}

    def tally(path: str, out: dict) -> dict:
        paths[path] = out["launches"]
        if "stem_launches" in out:
            stem[path] = out["stem_launches"]
        if "attention_launches" in out:
            attention[path] = out["attention_launches"]
        return out

    slice_out = tally("simclr", _timed("simclr", phase_slice, card))
    tally("graph", _timed("graph", phase_graph, card))
    tally("bench", _timed("bench", phase_bench, card))
    tally("simclr-resnet50", _timed("resnet50", phase_resnet50, card))
    for k, v in _timed("bottleneck family", phase_bottleneck_family, card).items():
        tally(f"simclr-{k}", v)
    tally("transforms", _timed("transforms", phase_transforms, card))
    tally("byol", _timed("byol", phase_byol, card))
    for k, v in _timed("family", phase_family, card).items():
        tally(k, v)
    _timed("small steps", phase_small_steps,
           ["byol", "simsiam", "simsiam-frozen", "relic", "barlow", "moco", "swav", "sela",
            "dino", "dino-resnet", "pirl", "deep_cluster"])
    _timed("probe steps", phase_probe_steps)
    for name, phase in (("moco", phase_moco), ("swav", phase_swav), ("sela", phase_sela),
                        ("dino", phase_dino), ("pirl", phase_pirl),
                        ("deep_cluster", phase_deep_cluster)):
        tally(name, _timed(name, phase, card))
    quality = _timed("quality", phase_quality, card)
    paths.update({"quality": quality["main"]["launches"],
                  "quality-nan": quality["nan"]["launches"],
                  "quality-shapes100": quality["shapes100"]["launches"]})
    tally("cifar", _timed("cifar", phase_cifar, card))
    paths["sweep"] = _timed("sweep", phase_sweep, card)["launches"]
    ddp = _timed("ddp", phase_ddp, card, slice_out)
    paths["ddp-torchrun"] = ddp["a"]["launches"]
    paths.update({f"ddp-gloo-{mode}": ddp["b"][mode]["launches"]
                  for mode in ("sync", "per_device_bn")})
    tp = _timed("tp", phase_tp, card)
    paths["tp-gloo"] = tp["a"]["launches"]
    paths["tp-dryrun"] = tp["b"]["launches"]
    _held_before_run("the end")
    print(f"[smoke] every phase passed in {time.perf_counter() - t0:.1f} s | {card}")
    kernels[0]["launches"] = sum(paths.values())
    kernels[0]["launches_by_path"] = paths
    kernels[1]["launches"] = sum(stem.values())
    kernels[1]["launches_by_path"] = stem
    kernels[2]["launches"] = sum(attention.values())
    kernels[2]["launches_by_path"] = attention
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
