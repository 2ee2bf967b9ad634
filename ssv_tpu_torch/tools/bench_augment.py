"""The augmentation's share of the train step on one CUDA card, the
counterpart of the JAX system's `scripts/bench_augment.py`:

    python -m ssv_tpu_torch.tools.bench_augment [batch]      (default 512)
    python -m ssv_tpu_torch.tools.bench_augment 8 --cpu      (a smoke run)

On the bench's images (`ssv_tpu_torch.bench`) it times one view's batch
transform of the shipped train config in each variant, and the bench's
full step, each as a CUDA graph captured once (the trainer's device
generator registered, on the trainers' graph stream, `train/graph.py`'s
discipline) and replayed `BA_SCAN` times (default 100) between two CUDA
events, median of 3 (the counterpart of JAX's scanned program):

  * `two_view_pallas_us`, `photometric_pallas_us`: the transform as the
    port runs it on the card, `build_batch_transform` with the photometric
    head (color jitter and the gray gate) in the CUDA kernel
    (`csrc/photometric.cu`); the whole transform, and the head alone;
  * `two_view_xla_us`, `photometric_xla_us`: the same with the head in its
    plain PyTorch version (`ops.photometric.photometric_reference`),
    composed here: the port's main path keeps the kernel always on;
  * `geometric_tail_us`: the resized crop, flip and normalize alone;
  * `full_step_us`: the bench's step at that batch, `Trainer.step`
    replayed from its graph (`bench.build_trainer`, 4 x batch images);
  * `aug_share_of_step` (2 plain views over the step),
    `aug_share_of_step_pallas` (2 kernel views), `geo_tail_share_of_step`.

The names keep JAX's `_pallas`/`_xla` so the rows line up with
`VALIDATION.md`'s: here `_pallas` is the CUDA kernel and `_xla` the plain
version. A "two_view" time is one view's transform, as in JAX's script;
the shares count two. `--cpu` times the plain variants and the step on the
CPU by the host clock and reports every kernel variant and its share as
null: no plain time stands under a kernel's name. Prints a line a variant,
then one JSON object.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

REPEATS = 3


def configs() -> dict:
    """The shipped train transform and its photometric head and geometric
    tail (JAX's `cfg_full`, `cfg_photo`, `cfg_geo`)."""
    from ..bench import mini_simclr

    full = mini_simclr(512)[1]["train"]
    return {"full": full,
            "photo": {k: full[k] for k in ("color_jitter", "random_gray")},
            "geo": {k: full[k] for k in ("random_resized_crop", "random_flip", "to_tensor",
                                         "normalize")}}


def plain_transform(cfg: dict):
    """`build_batch_transform(cfg)` with its photometric head in the plain
    PyTorch version on any device."""
    from ..data import augment
    from ..ops.photometric import photometric_reference, sample_photometric_params

    steps = augment._compile_steps(cfg)
    jitter = dict(cfg["color_jitter"] or {})
    apply_prob = jitter.pop("apply_prob", None)
    gray_p = float((cfg["random_gray"] or {}).get("p", 0.1))

    def transform(generator, imgs):
        imgs = augment.to_float(imgs)
        order, params = sample_photometric_params(imgs.shape[0], jitter, gray_p, apply_prob,
                                                  generator, imgs.device)
        return augment._run_steps(steps[2:], generator,
                                  photometric_reference(imgs, order, params))

    return transform


def variants(cuda: bool) -> dict:
    """name -> transform(generator, uint8 images), or None where the
    variant is the kernel's and the run has no card."""
    from ..data.augment import build_batch_transform

    cfg = configs()
    return {"two_view_pallas": build_batch_transform(cfg["full"]) if cuda else None,
            "two_view_xla": plain_transform(cfg["full"]),
            "photometric_pallas": build_batch_transform(cfg["photo"]) if cuda else None,
            "photometric_xla": plain_transform(cfg["photo"]),
            "geometric_tail": build_batch_transform(cfg["geo"])}


def graph_us(fn, generator, scan: int) -> float:
    """fn() captured once as a CUDA graph (the generator registered) and
    replayed `scan` times between two events: µs a call, median of
    REPEATS."""
    from ..train.graph import side_stream

    side = side_stream(torch.device("cuda"))
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with torch.cuda.graph(graph, stream=side):
        fn()
    times = []
    for _ in range(REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(scan):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / scan)
    del graph
    return statistics.median(times)


def host_us(fn, scan: int) -> float:
    """fn() `scan` times by the host clock: µs a call, median of REPEATS."""
    fn()
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(scan):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / scan)
    return statistics.median(times)


def step_us(batch: int, scan: int, device: str) -> float:
    """The bench's step at `batch` (4 x batch images): on the card its graph
    replayed, `scan` steps between two events after the warm-up and the
    capture, median of REPEATS; on the CPU the eager step by the host
    clock."""
    from ..bench import build_trainer, epoch_permutation, index_matrix
    from ..train.graph import WARMUP_STEPS

    n_train = 4 * batch
    trainer = build_trainer(batch, n_train, device)
    state = trainer.state
    warm = WARMUP_STEPS + 1
    state.scheduler.reserve(warm + (REPEATS + 1) * scan)
    idx = index_matrix(epoch_permutation(0, n_train), max(scan, warm), batch).to(trainer.device)
    trainer.begin_epoch(idx)
    for _ in range(warm):
        trainer.step(state)

    def epoch():
        trainer.begin_epoch(idx)
        for _ in range(scan):
            trainer.step(state)

    if device == "cpu":
        return host_us(epoch, 1) / scan
    times = []
    for _ in range(REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        epoch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / scan)
    if trainer.graph is None or trainer.graph.replays < REPEATS * scan:
        raise RuntimeError("the bench's step was not replayed from one graph")
    return statistics.median(times)


def run(batch: int = 512, cpu: bool = False, scan: int | None = None) -> dict:
    from ..bench import bench_images

    scan = int(os.environ.get("BA_SCAN", 100)) if scan is None else scan
    cuda = not cpu
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("bench_augment measures on a CUDA card; none found (--cpu for "
                           "the plain variants on the CPU)")
    device = "cuda" if cuda else "cpu"
    images = torch.from_numpy(bench_images(batch)).to(device)
    generator = torch.Generator(device=device).manual_seed(0)
    out = {"batch": batch, "scan": scan, "device": device}
    for name, transform in variants(cuda).items():
        if transform is None:
            out[name + "_us"] = None
            print(f"{name:24s}     null (the CUDA kernel: no card, --cpu)", flush=True)
            continue

        def call(transform=transform):
            transform(generator, images)

        us = graph_us(call, generator, scan) if cuda else host_us(call, scan)
        out[name + "_us"] = us
        print(f"{name:24s} {us:10.1f} us/batch ({batch / us * 1e6:,.0f} img/s)", flush=True)
    out["full_step_us"] = step_us(batch, scan, device)

    def share(key):
        return None if out[key] is None else 2 * out[key] / out["full_step_us"]

    out["aug_share_of_step"] = share("two_view_xla_us")
    out["aug_share_of_step_pallas"] = share("two_view_pallas_us")
    out["geo_tail_share_of_step"] = share("geometric_tail_us")
    if cuda:
        from .measure import card_line
        out["card"] = card_line()
    print(f"full step: {out['full_step_us']:.1f} us | 2-view aug share "
          f"{out['aug_share_of_step']:.1%} (plain), "
          + (f"{out['aug_share_of_step_pallas']:.1%} (kernel)"
             if cuda else "null (kernel)")
          + f" | geometric tail share {out['geo_tail_share_of_step']:.1%}"
          + (f" | {out['card']}" if cuda else ""), flush=True)
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    batch = next((int(a) for a in argv if a.isdigit()), 512)
    print(json.dumps(run(batch, cpu="--cpu" in argv)))


if __name__ == "__main__":
    main()
