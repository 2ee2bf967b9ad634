"""Quality runs of the port (the port of scripts/quality_run.py): the shipped
configs/<algo>.yaml at full width for many epochs, the 20-NN KNN every few
epochs, the final linear probe.

    python -m ssv_tpu_torch.tools.quality_run --algos moco,simclr --epochs 40 \\
        --dataset synth100 --tag synth100-rank-40ep

The config is overridden only in `epochs`, `eval_every`, the dataset, the
batch (`--batch`) and the dotted `--set key=yaml_value` pairs. At every eval
epoch the full state is saved to `latest`, and `--resume` restarts a cut run
from there. For BYOL, SimSiam and DINO (or any algorithm with
`--probe-encoder`) the KNN of the raw backbone features is also recorded
where the algorithm's `embed_backbone` returns features; DINO's rows carry
its teacher-output probe, SeLA's and DeepCluster's the entropy of their
pseudo-labels each epoch. The line after the dataset's, `[<algo>] row:
{"arch": ..., "overrides": ...}`, names the run's backbone and `--set`
overrides. Each eval line also prints the graphs captured in the run so
far (`captures`), the mean seconds an epoch spent outside its
steps since the last eval (`outside_s`: pre/post_epoch and the draw) and,
on the card, the allocated and peak GiB.

A non-finite loss ends the run: the KNN of that state is recorded with
`nan_at`, and the linear probe is not run (`linear` is null), so every JSON
line is strict JSON (`scripts/quality_run.py` probes the NaN state and can
print a bare NaN). One JSON line is printed per algorithm, an `error` row
where it failed; the rows are appended as they finish to the markdown file
`--out` (default `outputs/quality/<tag>.md`), whose header names the card
(`nvidia-smi`'s name and power limit) or the CPU. Each algorithm's run
directory is `<out without .md>/<algo>/`.

Runs on the CUDA card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ARCH = {"dino": "vit"}  # resnet18 otherwise

# algorithms with a projector/predictor asymmetry, whose full-path KNN can be
# noisy while the backbone is fine: their rows carry the backbone's KNN
PROBE_DEFAULT = {"byol", "simsiam", "dino"}


def _set_dotted(cfg: dict, key: str, value):
    """Apply `a.b.c=value` into nested dicts (creates intermediate dicts)."""
    parts = key.split(".")
    d = cfg
    for i, p in enumerate(parts[:-1]):
        if p in d and not isinstance(d[p], dict):
            raise ValueError(
                f"--set {key}: {'.'.join(parts[:i + 1])} is a scalar "
                f"({d[p]!r}), cannot descend into it")
        d = d.setdefault(p, {})
    d[parts[-1]] = value


def quality_config(algo: str, epochs: int, dataset: str, eval_every: int,
                   batch: int | None, overrides: dict) -> dict:
    """configs/<algo>.yaml with the run's overrides."""
    with open(os.path.join(REPO, "configs", f"{algo}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["epochs"] = epochs
    cfg["eval_every"] = eval_every
    cfg["data"]["dataset_name"] = dataset
    cfg["wandb"] = {"project": None}
    if batch:
        cfg["data"]["batch_size"] = batch
    for k, v in overrides.items():
        _set_dotted(cfg, k, v)
    return cfg


def pseudo_entropy(labels) -> float:
    """Entropy (nats, to 3 places) of the pseudo-label distribution: with
    loss -> 0 and collapsed labels it falls below 0.5 log K."""
    counts = np.bincount(np.asarray(labels))
    p = counts[counts > 0] / counts.sum()
    return round(float(-(p * np.log(p)).sum()), 3)


def pseudo_labels(state):
    """SeLA's or DeepCluster's pseudo-labels as a host array, else None."""
    extra = state.extra
    if "self_label" in extra:
        return extra["self_label"].pseudo_labels.cpu().numpy()
    if "pseudo_labels" in extra:
        return extra["pseudo_labels"].labels.cpu().numpy()
    return None


def _has_backbone(tr) -> bool:
    """Whether the algorithm's `embed_backbone` returns features."""
    images, _ = tr.pipeline.arrays("test")
    x = tr._eval_t(torch.Generator(device=tr.device).manual_seed(0), images[:2])
    return tr.algorithm.embed_backbone(tr.state, x) is not None


def run_one(algo: str, epochs: int, dataset: str, eval_every: int,
            sizes: tuple[int, int], batch: int | None, overrides: dict,
            probe_encoder: bool = False, arch: str | None = None,
            resume: bool = False, device: str | None = None,
            run_root: str = os.path.join("outputs", "quality"), seed: int = 420) -> dict:
    """One algorithm's run in `<run_root>/<algo>/`; returns its row."""
    from ..evals.knn import compute_neighbor_accuracy
    from ..train.trainer import Trainer
    from ..utils import trace

    cfg = quality_config(algo, epochs, dataset, eval_every, batch, overrides)
    d = os.path.join(run_root, algo)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cfg.yaml"), "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    args = {"config": os.path.join(d, "cfg.yaml"), "algo": algo,
            "arch": arch or ARCH.get(algo, "resnet18"), "task": "train",
            "output": os.path.abspath(os.path.join(d, "run")), "load": None}

    t0 = time.time()
    tr = Trainer(args, synthetic_sizes=sizes, device=device, seed=seed)
    ds = tr.pipeline.dataset
    resolved = ds.name + (" → synthetic fallback" if ds.synthetic
                          and ds.name not in ("synth100", "shapes100") else "")
    resolved += f" ({len(ds.train.images):,} train / {len(ds.test.images):,} test)"
    print(f"[{algo}] dataset resolved: {resolved}", flush=True)
    # the backbone and overrides that, with the algorithm, name the row
    print(f"[{algo}] row: " + json.dumps({"arch": args["arch"], "overrides": overrides}),
          flush=True)
    start_epoch = 1
    if resume:
        try:
            tr.load_checkpoint(tr.output_dir)
            state = tr.state
            start_epoch = tr.start_epoch
            print(f"[{algo}] resumed from {tr.output_dir} at epoch {start_epoch}", flush=True)
        except FileNotFoundError:
            state = tr.algorithm.pre_train(tr.state, tr)
    else:
        state = tr.algorithm.pre_train(tr.state, tr)
    knn_curve, ips_hist, ent_curve, backbone_curve, teacher_curve = [], [], [], [], []
    nan_at = None
    probe = (probe_encoder or algo in PROBE_DEFAULT) and _has_backbone(tr)
    cuda = tr.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(tr.device)
    captures = trace.counters.get("graph.captures", 0)
    outside = []  # each epoch's seconds outside its steps (pre/post_epoch, the draw)

    for e in range(start_epoch, epochs + 1):
        t_epoch = time.time()
        state = tr.algorithm.pre_epoch(state, tr, e)
        labels = pseudo_labels(state)
        if labels is not None:
            ent_curve.append(pseudo_entropy(labels))
        idx_mat = tr.epoch_indices()
        te = time.time()
        state, metrics, _ = tr._run_epoch(state, idx_mat)
        t_steps = time.time() - te
        state = tr.algorithm.post_epoch(state, e)
        loss = float(metrics["loss"].mean())
        ips_hist.append(idx_mat.numel() / (time.time() - te))
        outside.append(time.time() - t_epoch - t_steps)
        if not math.isfinite(loss):
            # terminal: every later epoch trains from non-finite weights.
            # Record the KNN of this state and stop; no probe (below).
            tr.state = state
            knn = tr.knn_validate()
            knn_curve.append((e, round(knn, 4)))
            nan_at = e
            print(f"[{algo}/{dataset}] epoch {e}: loss={loss} — non-finite state is "
                  f"terminal, aborting (knn={knn:.4f})", flush=True)
            break
        if e % eval_every == 0 or e == epochs:
            tr.state = state
            tr.save_checkpoint("latest", epoch=e)
            knn = tr.knn_validate()
            knn_curve.append((e, round(knn, 4)))
            msg = (f"[{algo}/{dataset}] epoch {e}/{epochs} loss={loss:.4f} "
                   f"knn={knn:.4f} ips={ips_hist[-1]:,.0f}")
            if probe:
                fv, gt = tr.features_for(state, "test",
                                         feature_fn=tr.algorithm.embed_backbone)
                bk = compute_neighbor_accuracy(fv, gt, k=20)
                backbone_curve.append((e, round(bk, 4)))
                msg += f" knn_backbone={bk:.4f}"
            if hasattr(tr.algorithm, "teacher_stats"):
                # is the teacher's target sample-dependent at all? (mi == 0
                # iff it is not: the absorbing uniform point)
                t_out, _ = tr.features_for(state, "test",
                                           feature_fn=tr.algorithm.embed_teacher)
                ts = tr.algorithm.teacher_stats(state, t_out)
                teacher_curve.append(
                    (e, round(ts["mi"], 5), f"{ts['prob_std']:.2e}",
                     round(ts["raw_std"], 4), round(ts["ent_frac"], 4)))
                msg += (f" t_mi={ts['mi']:.5f} t_pstd={ts['prob_std']:.2e}"
                        f" t_rawstd={ts['raw_std']:.4f} t_entfrac={ts['ent_frac']:.4f}")
            msg += (f" captures={trace.counters.get('graph.captures', 0) - captures}"
                    f" outside_s={float(np.mean(outside)):.3f}")
            outside = []
            if cuda:
                msg += (f" alloc_gib={torch.cuda.memory_allocated(tr.device) / 2**30:.3f}"
                        f" peak_gib={torch.cuda.max_memory_allocated(tr.device) / 2**30:.3f}")
            print(msg, flush=True)
    tr.state = state
    linear = None if nan_at is not None else round(float(tr.perform_linear_eval()), 4)
    extra_fields = {}
    if backbone_curve:
        extra_fields["knn_backbone_curve"] = backbone_curve
        extra_fields["best_knn_backbone"] = max(k for _, k in backbone_curve)
    if teacher_curve:
        extra_fields["teacher_probe_curve"] = teacher_curve
    if ent_curve:
        K = getattr(tr.algorithm, "num_clusters", getattr(tr.algorithm, "num_classes", None))
        extra_fields.update({
            "pseudo_entropy_min": min(ent_curve),
            "pseudo_entropy_last": ent_curve[-1],
            "half_log_K": round(0.5 * float(np.log(K)), 3) if K else None,
        })
    if start_epoch > 1:
        extra_fields["resumed_at"] = start_epoch
    if nan_at is not None:
        extra_fields["nan_at"] = nan_at
    if seed != 420:
        extra_fields["seed"] = seed
    return {
        **extra_fields,
        "algo": algo, "dataset": dataset, "resolved_dataset": resolved,
        "epochs": epochs,
        "batch": cfg["data"]["batch_size"],
        "knn_curve": knn_curve,
        "best_knn": max(k for _, k in knn_curve),
        "final_knn": knn_curve[-1][1],
        "linear": linear,
        "img_per_sec": round(max(ips_hist)),
        "wall_s": round(time.time() - t0),
    }


HEADER = ("| algorithm | batch | KNN curve (epoch: acc) | best KNN | "
          "backbone KNN (best) | linear | img/s/chip | wall |\n"
          "|---|---|---|---|---|---|---|---|\n")


def table_row(r: dict) -> str:
    """A row's line of the markdown table."""
    if "error" in r:
        return f"| {r['algo']} | — | ERROR: {r['error']} | — | — | — | — | — |\n"
    curve = " ".join(f"{e}:{k}" for e, k in r["knn_curve"])
    if r.get("resumed_at"):
        curve = f"(resumed @{r['resumed_at']}) " + curve
    if r.get("nan_at"):
        curve += f" — **loss NaN by epoch {r['nan_at']}, aborted (terminal state)**"
    bk = r.get("best_knn_backbone")
    linear = r["linear"] if r["linear"] is not None else "— (not run: non-finite state)"
    return (f"| {r['algo']} | {r['batch']} | {curve} | {r['best_knn']} | "
            f"{bk if bk is not None else '—'} | {linear} | "
            f"{r['img_per_sec']:,} | {r['wall_s']}s |\n")


def hardware(device: str) -> str:
    """The card as nvidia-smi names it (name, power limit), or "CPU"."""
    if device == "cpu":
        return "CPU"
    from .measure import card_line

    return card_line()


def main(argv=None) -> int:
    """Runs each algorithm; returns 1 if any row is an error, else 0."""
    ap = argparse.ArgumentParser(prog="python -m ssv_tpu_torch.tools.quality_run")
    ap.add_argument("--algos", required=True)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--dataset", default="cifar10",
                    help="cifar10 (synthetic fallback), synth100 (phase-randomized "
                         "textures: contrastive ranking) or shapes100 "
                         "(augmentation-invariant layouts)")
    ap.add_argument("--eval-every", type=int, default=0, help="0 = epochs//5")
    ap.add_argument("--n-train", type=int, default=50000)
    ap.add_argument("--n-test", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=yaml_value; dotted keys descend "
                         "(data.transforms.train.random_resized_crop.scale=[0.5,1])")
    ap.add_argument("--arch", default=None,
                    help="backbone (default: vit for dino, else resnet18)")
    ap.add_argument("--probe-encoder", action="store_true",
                    help="also record the raw-backbone KNN at eval epochs; "
                         "default-on for byol/simsiam/dino")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device to run on (default: cuda)")
    ap.add_argument("--seed", type=int, default=420, help="the Trainer's seed")
    ap.add_argument("--resume", action="store_true",
                    help="resume each run from its `latest` checkpoint")
    ap.add_argument("--out", default=None,
                    help="markdown file the rows are appended to "
                         "(default outputs/quality/<tag>.md)")
    ap.add_argument("--no-write", action="store_true",
                    help="write no markdown (smoke runs)")
    args = ap.parse_args(argv)

    eval_every = args.eval_every or max(1, args.epochs // 5)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = yaml.safe_load(v)
    out = args.out or os.path.join("outputs", "quality", f"{args.tag}.md")
    run_root = os.path.splitext(out)[0]

    # the table grows a row per finished algorithm, so a cut multi-algorithm
    # run keeps the rows it finished
    header_written = False

    def append_row(r):
        nonlocal header_written
        if args.no_write:
            return
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            if not header_written:
                resolved = r.get("resolved_dataset",
                                 f"{args.dataset} ({args.n_train:,} train / "
                                 f"{args.n_test:,} test)")
                f.write(f"\n## Quality run: {args.tag}\n\n")
                f.write(f"{hardware(args.device)}, dataset `{resolved}`, {args.epochs} "
                        "epochs, shipped full-size configs"
                        + (f", overrides {overrides}" if overrides else "")
                        + (f", seed {args.seed}" if args.seed != 420 else "") + ".\n\n")
                f.write(HEADER)
                header_written = True
            f.write(table_row(r))

    results = []
    for algo in args.algos.split(","):
        try:
            r = run_one(algo, args.epochs, args.dataset, eval_every,
                        (args.n_train, args.n_test), args.batch or None, overrides,
                        probe_encoder=args.probe_encoder, arch=args.arch,
                        resume=args.resume, device=args.device, run_root=run_root,
                        seed=args.seed)
        except Exception as e:  # an error row, and the next algorithm
            r = {"algo": algo, "error": f"{type(e).__name__}: {e}"}
        results.append(r)
        print(json.dumps(r, allow_nan=False), flush=True)
        append_row(r)

    if header_written:
        with open(out, "a") as f:
            notes = [f"{r['algo']}: pseudo-label entropy min {r['pseudo_entropy_min']} "
                     f"/ last {r['pseudo_entropy_last']} (collapse bar 0.5·log K = "
                     f"{r['half_log_K']})"
                     for r in results if r.get("pseudo_entropy_min") is not None]
            if notes:
                f.write("\n" + "; ".join(notes) + ".\n")
            for r in results:
                if r.get("teacher_probe_curve"):
                    rows = "; ".join(
                        f"ep{e}: mi={mi} prob_std={ps} raw_std={rs} ent_frac={ef}"
                        for e, mi, ps, rs, ef in r["teacher_probe_curve"])
                    f.write(f"\n{r['algo']} teacher-output probe (test split; mi = "
                            f"H(mean p) − mean H(p), 0 iff the teacher is "
                            f"sample-independent): {rows}.\n")
            f.write("\nGenerated by `python -m ssv_tpu_torch.tools.quality_run`.\n")
        print("WROTE", out, flush=True)
    return 1 if any("error" in r for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
