"""Where a train step's time goes, on one CUDA card:

    python -m ssv_tpu_torch.tools.step_profile -c configs/dino.yaml -m vit -a dino

Builds the algorithm's `Trainer` on the config (the full-size synthetic
CIFAR-10 where no CIFAR is on disk), runs `--warmup` train steps in the
trainer's epoch mode (graph replays by default, `jit_epoch: false` in the
config for the eager step; the warm-up covers the graph's capture), then
times `--steps` steps, and as many batches alone, by the host clock (each
run ends in a synchronise), then profiles `--profiled` steps: the device
ops a step (kernels, copies and sets; not the profiler's annotations), the
union of their intervals (the device's busy time a step) and its share of
the unprofiled step, their device time by kind, and the kernels that take
the most of it.
Prints a line for each and, last, one JSON object. Needs one card.

With `--turns` it measures both epoch modes in turns in one process (step,
graph, graph, step: the eager step, `jit_epoch: false`, and the step
captured as a CUDA graph and replayed, the default), each turn a fresh
`Trainer` on bench.py's 8,192 random synthetic images at the config's
batch, and prints each mode's means; in graph mode also the capture's
seconds and the graph's pool; and the device ops a step by name whose
counts differ between the modes (`op_count_diff`):

    python -m ssv_tpu_torch.tools.step_profile -c configs/simclr.yaml -m resnet18 -a simclr --turns

Under torchrun it profiles each rank's steps on its slice of the global
batch, and counts the collectives of a step (calls, bytes, and the host
milliseconds inside them: the whole collective on gloo, the enqueue on
NCCL, whose kernels the profiler's "collectives" kind times):

    torchrun --nproc_per_node 2 -m ssv_tpu_torch.tools.step_profile -c configs/simclr.yaml -m resnet18 -a simclr --backend gloo

(`--backend gloo` puts rank r on card r mod the cards: two ranks can
share one card, which NCCL refuses).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import tempfile
import time

import torch

from .measure import card_line


def busy_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


# ranges the profiler mirrors on the card's timeline around the kernels of
# an optimizer step or a profiler step; not device work of their own
ANNOTATIONS = ("Optimizer.step#", "Optimizer.zero_grad#", "ProfilerStep#")


# kinds of device work, by the first pattern a kernel's name contains
KINDS = (("photometric kernel", ("photometric_kernel",)),
         ("collectives", ("nccl",)),
         ("matmul and conv", ("gemm", "xmma", "nvjet", "cutlass", "conv", "sm90_", "sm80_")),
         ("normalisation", ("layer_norm", "GammaBeta", "batch_norm", "bn_fw", "bn_bw")),
         ("copies and casts", ("copy", "Memcpy", "Memset")),
         ("optimizer (foreach)", ("multi_tensor_apply",)),
         ("softmax", ("softmax",)),
         ("pooling", ("pool",)))


def kind_of(name: str) -> str:
    for kind, patterns in KINDS:
        if any(p in name for p in patterns):
            return kind
    return "elementwise and other"


def device_ops(events) -> list:
    """The profiler's events that ran on the card, without the annotations
    it mirrors there (user ranges, `Optimizer.step#...`)."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(ANNOTATIONS)]


def profile_steps(config: str, arch: str, algo: str, warmup: int = 10, steps: int = 30,
                  profiled: int = 5, top: int = 15) -> dict:
    from ..train.trainer import Trainer

    if not torch.cuda.is_available():
        raise RuntimeError("step_profile measures on a CUDA card; none found")
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer({"config": config, "algo": algo, "arch": arch, "task": "train",
                           "output": os.path.join(tmp, "run")})
        result = profile_trainer(trainer, warmup, steps, profiled, top)
        del trainer
    return result


def profile_trainer(trainer, warmup: int = 10, steps: int = 30, profiled: int = 5,
                    top: int = 15) -> dict:
    """The measurements above on a built `Trainer` (its state trains on,
    epoch after epoch where one is shorter than the steps asked for)."""
    from torch.profiler import ProfilerActivity, profile

    from ..parallel import batch_slice, rank, world_size
    from ..utils import trace

    card = card_line()
    algo, arch = trainer.args["algo"], trainer.args["arch"]
    idx = trainer.epoch_indices()
    rows = idx.shape[0]
    images, labels = trainer.pipeline.arrays("train")
    state = trainer.state
    taken = 0

    def batch(s):
        return trainer._batch_fn(images, labels, batch_slice(idx[s % rows]), trainer.generator)

    def step(s):
        # the epoch's next row in the trainer's mode; a new epoch after its last
        nonlocal taken
        if taken and taken % rows == 0:
            trainer.begin_epoch(trainer.epoch_indices())
        trainer.step(state)
        taken += 1

    trainer.begin_epoch(idx)

    def host_ms(fn, first):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(first, first + steps):
            fn(s)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    for s in range(warmup):
        step(s)
    before = {k: trace.counters.get(f"collectives.{k}", 0) for k in ("calls", "bytes", "host_s")}
    step_ms = host_ms(step, warmup)
    coll = {k: trace.counters.get(f"collectives.{k}", 0) - v for k, v in before.items()}
    coll = {"collectives_per_step": coll["calls"] / steps,
            "collective_mb_per_step": coll["bytes"] / steps / 1e6,
            "collective_host_ms_per_step": coll["host_s"] / steps * 1e3}
    batch_ms = host_ms(batch, warmup + steps)
    first = warmup + 2 * steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in range(first, first + profiled):
            step(s)
        torch.cuda.synchronize()
    ops = device_ops(prof.events())
    batch_size = trainer.pipeline.batch_size
    del state
    by_name: dict[str, float] = {}
    count: dict[str, int] = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
        count[e.name] = count.get(e.name, 0) + 1
    by_kind: dict[str, float] = {}
    for name, us in by_name.items():
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + us / profiled / 1e3
    busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in ops) / profiled / 1e3
    result = {
        "algo": algo, "arch": arch, "batch": batch_size, "ranks": world_size(),
        "rank": rank(), "mode": trainer.epoch_mode, "step_ms": step_ms,
        "img_per_s": batch_size / step_ms * 1e3, "batch_ms": batch_ms,
        "device_ops_per_step": len(ops) / profiled, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / step_ms,
        "ms_per_step_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top_us_per_step": {n: us / profiled for n, us in
                            sorted(by_name.items(), key=lambda kv: -kv[1])[:top]},
        "ops_per_step_by_name": {n: c / profiled for n, c in count.items()},
        "capture_s": trace.last_seconds("graph.capture") if trainer.graph else None,
        "pool_bytes": trainer.graph.pool_bytes if trainer.graph else None,
        **coll, "card": card}
    if world_size() > 1:
        print(f"[step_profile] rank {rank()} of {world_size()}: {coll['collectives_per_step']:.1f} "
              f"collectives a step, {coll['collective_mb_per_step']:.3f} MB, "
              f"{coll['collective_host_ms_per_step']:.3f} ms of the host inside them")
    print(f"[step_profile] {algo} {arch} batch {batch_size}, {trainer.epoch_mode} mode: "
          f"{step_ms:.3f} ms a step by the "
          f"host clock over {steps} steps ({result['img_per_s']:.1f} img/s), the batch alone "
          f"{batch_ms:.3f} ms; under the profiler {result['device_ops_per_step']:.1f} device "
          f"ops a step, the device busy {busy_ms:.3f} ms a step, "
          f"{result['device_busy_share']:.3f} of the unprofiled step"
          + (f"; capture {result['capture_s']:.3f} s, pool "
             f"{result['pool_bytes'] / 2**30:.3f} GiB" if trainer.graph else "") + f" | {card}")
    print("[step_profile] device ms a step by kind: " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["ms_per_step_by_kind"].items()))
    for name, us in result["top_us_per_step"].items():
        print(f"[step_profile]   {us:9.1f} us a step  {name[:120]}")
    return result


TURNS = ("step", "graph", "graph", "step")
TURN_IMAGES = 8192   # bench.py's random images
MEANED = ("img_per_s", "step_ms", "device_ops_per_step", "device_busy_ms", "device_busy_share")


def profile_modes(config: str, arch: str, algo: str) -> dict:
    """Both epoch modes in TURNS, each a fresh Trainer on TURN_IMAGES random
    synthetic images (its pre-train hook run, as `train` runs it) measured
    by `profile_trainer`; prints and returns each mode's means of MEANED."""
    from ..train.trainer import Trainer

    card = card_line()
    rows = []
    for mode in TURNS:
        trainer = Trainer({"config": config, "algo": algo, "arch": arch, "task": "train",
                           "output": "step_profile"}, overrides={"jit_epoch": mode == "graph"},
                          synthetic_sizes=(TURN_IMAGES, 1024), make_dirs=False)
        if trainer.epoch_mode != mode:
            raise RuntimeError(f"asked for {mode} mode, the trainer runs {trainer.epoch_mode} "
                               f"({trainer.epoch_mode_reason})")
        trainer.algorithm.pre_train(trainer.state, trainer)
        rows.append(profile_trainer(trainer, top=5))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    means, by_name = {}, {}
    for mode in TURNS[:2]:
        mine = [r for r in rows if r["mode"] == mode]
        means[mode] = {k: statistics.mean(r[k] for r in mine) for k in MEANED}
        names = {n for r in mine for n in r["ops_per_step_by_name"]}
        by_name[mode] = {n: statistics.mean(r["ops_per_step_by_name"].get(n, 0.0) for r in mine)
                         for n in names}
        m = means[mode]
        print(f"[step_profile] {algo} {arch} {mode} mode, mean of {len(mine)} turns: "
              f"{m['img_per_s']:.1f} img/s, {m['step_ms']:.3f} host ms a step, "
              f"{m['device_ops_per_step']:.1f} device ops, busy share "
              f"{m['device_busy_share']:.3f} | {card}", flush=True)
    diff = op_count_diff(by_name["step"], by_name["graph"])
    print(f"[step_profile] {algo} {arch} device ops a step by name, graph minus step: "
          + (", ".join(f"{d:+.1f} {n[:100]}" for n, d in diff.items()) or "none differ"),
          flush=True)
    return {"algo": algo, "arch": arch, "turns": rows, "means": means,
            "op_count_diff": diff, "card": card}


def op_count_diff(step: dict, graph: dict) -> dict:
    """{op name: graph's count a step minus step mode's} for every name whose
    counts differ, the largest differences first."""
    diff = {n: graph.get(n, 0.0) - step.get(n, 0.0) for n in set(step) | set(graph)}
    return dict(sorted(((n, d) for n, d in diff.items() if d),
                       key=lambda kv: (-abs(kv[1]), kv[0])))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ssv_tpu_torch.tools.step_profile")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-m", "--arch", required=True)
    ap.add_argument("-a", "--algo", required=True)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--profiled", type=int, default=5)
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="the process group's backend under torchrun (default: nccl)")
    ap.add_argument("--turns", action="store_true",
                    help="both epoch modes in turns on 8,192 images, one process")
    args = ap.parse_args(argv)
    from ..parallel import mesh

    if args.turns:
        if not torch.cuda.is_available():
            raise RuntimeError("step_profile measures on a CUDA card; none found")
        print(json.dumps(profile_modes(args.config, args.arch, args.algo)))
        return
    if mesh.launched():
        # gloo lets ranks share a card: rank r on card r mod the cards
        local = int(os.environ.get("LOCAL_RANK", 0)) % max(torch.cuda.device_count(), 1)
        mesh.init(f"cuda:{local}" if args.backend == "gloo" else "cuda", backend=args.backend)
    try:
        print(json.dumps(profile_steps(args.config, args.arch, args.algo, args.warmup,
                                       args.steps, args.profiled)))
    finally:
        mesh.destroy()


if __name__ == "__main__":
    main()
