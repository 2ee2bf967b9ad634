"""Every algorithm for a few epochs on the card (the port of
scripts/tpu_sweep.py): per-epoch losses, the 20-NN KNN after the last
epoch, and the best epoch's img/s, for the 12 rows of `SWEEP` on the
synthetic CIFAR-10 (10,240 train / 2,048 test) with `mini_config`'s small
heads at the row's batch.

    python -m ssv_tpu_torch.tools.sweep [epochs] [--only simclr,sela] [--no-write]
        [--update-floors] [--results FILE] [--device cpu]
    python -m ssv_tpu_torch.tools.sweep --floors-from a.json b.json c.json

It is also the throughput guard: each row is held against its floor in
`sweep_floors.json` (beside this file), and a row below 0.8 of its floor,
or an error row, makes the sweep exit 1. `--update-floors` writes this
run's img/s as the floors, with the card line; `--floors-from` writes the
slowest of several runs' `--results` files instead, as the committed floors
are taken (calls on the same code differ by the host they get). The table
goes to `outputs/sweep/table.md`; `--no-write` writes neither the table nor
floors and skips the guard. Each row's run directory is
`outputs/sweep/runs/<row>/`.

Runs on the CUDA card unless `--device cpu` is given; `--n-train`,
`--n-test`, `--arch` and `--batch` cut the rows to a test's size.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import yaml

FLOORS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sweep_floors.json")
TABLE_PATH = os.path.join("outputs", "sweep", "table.md")
FLOOR_RATIO = 0.8
SIZES = (10240, 2048)

# (row name, algo, arch, batch, config overrides)
SWEEP = [
    ("simclr", "simclr", "resnet18", 256, {}),
    ("moco", "moco", "resnet18", 256, {}),
    ("byol", "byol", "resnet18", 256, {}),
    ("simsiam", "simsiam", "resnet18", 256, {}),
    ("relic", "relic", "resnet18", 256, {}),
    ("relic+fuse", "relic", "resnet18", 256, {"fuse_views": True}),
    ("barlow", "barlow", "resnet18", 256, {}),
    ("swav", "swav", "resnet18", 256, {}),
    ("pirl", "pirl", "resnet18", 256, {}),
    ("deep_cluster", "deep_cluster", "resnet18", 256, {}),
    ("sela", "sela", "resnet18", 250, {}),
    ("dino", "dino", "vit", 32, {}),  # fuse_views on by default for the ViT;
    # runs at mini_config's DINO batch of 8, which replaces the row's data block
]

# ----------------------------------------------------------------------
# the sweep's configs: a copy of tests/helpers.py's `mini_config` (held
# equal to it by tests/test_torch_sweep.py)
# ----------------------------------------------------------------------
NORM = {"mean": [0.4914, 0.4822, 0.4465], "std": [0.2470, 0.2435, 0.2616]}


def train_t():
    return {
        "color_jitter": {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4,
                         "hue": 0.1, "apply_prob": 0.8},
        "random_gray": {"p": 0.2},
        "random_resized_crop": {"size": [32, 32], "scale": [0.2, 1.0]},
        "random_flip": None,
        "to_tensor": None,
        "normalize": copy.deepcopy(NORM),
    }


def test_t():
    return {"center_crop": {"size": [32, 32]}, "to_tensor": None,
            "normalize": copy.deepcopy(NORM)}


def mini_config(algo: str, epochs=1, batch_size=16):
    data = {"dataset_name": "cifar10", "root": "/tmp/nonexistent-data",
            "batch_size": batch_size,
            "transforms": {"train": train_t(), "test": test_t()}}
    cfg = {
        "epochs": epochs, "eval_every": 1,
        "data": data,
        "encoder": {"reduce_bottom_conv": True},
        "optimizer": {"name": "sgd", "lr": 0.1, "momentum": 0.9,
                      "nesterov": True, "weight_decay": 1e-4},
        "scheduler": {"name": "cosine", "warmup_epochs": 0},
        "linear_eval": {"epochs": 2, "input_dim": 16, "batch_size": 16, "lr": 0.1},
        "wandb": {"project": None},
    }
    extras = {
        "simclr": {"proj_dim": 16, "loss_fn": {"normalize": True, "temperature": 0.5}},
        "moco": {"proj_dim": 16, "queue_size": 64, "momentum": 0.99,
                 "loss_fn": {"normalize": True, "temperature": 0.07}},
        "byol": {"proj_dim": 16, "tau": 0.99},
        "relic": {"proj_dim": 16, "tau": 0.99,
                  "loss_fn": {"normalize": True, "temperature": 1.0, "alpha": 0.5}},
        "simsiam": {"proj_dim": 32, "bottleneck_dim": 8},
        "barlow": {"proj_dim": 32,
                   "loss_fn": {"normalize": False, "off_diagonal_weight": 0.005}},
        "swav": {"hidden_dim": 32, "proj_dim": 16, "prototype_size": 40,
                 "feature_bank_size": 48,
                 "loss_fn": {"temperature": 0.1, "sinkhorn_eps": 0.05,
                             "sinkhorn_iters": 3}},
        "pirl": {"proj_dim": 16, "patch_size": 16, "num_patches": 4,
                 "num_negatives": 24, "momentum": 0.5,
                 "loss_fn": {"normalize": True, "temperature": 0.07,
                             "loss_weight": 0.5}},
        "deep_cluster": {"num_classes": 4, "kmeans": {"n_iters": 10, "n_redo": 2}},
        "sela": {"num_clusters": 8, "num_cluster_heads": 3, "lambda": 25,
                 "self_label_iters": 5},
        "dino": {},
    }
    cfg.update(extras[algo])
    if algo == "sela":
        cfg["data"]["transforms"] = {"aug": train_t(), "std": test_t()}
    if algo == "dino":
        cfg.update({
            "eval_every": 1,
            "teacher_temp_lower": 0.04, "teacher_temp_upper": 0.07,
            "student_temp": 0.1, "center_momentum": 0.9,
            "weight_decay_upper": 0.4, "weight_decay_lower": 0.04,
            "lambda_upper": 1.0, "lambda_lower": 0.99, "gradient_clip": 3.0,
            "proj_head": {"hidden_dim": 24, "proj_dim": 16},
            "optimizer": {"name": "adamw", "lr": 1e-4, "epsilon": 1e-6,
                          "weight_decay": 0.04},
            "encoder": {"hidden_dim": 32, "embedding_dim": 16,
                        "intermediate_dim": 48, "num_attention_heads": 4,
                        "patch_size": 4, "num_local_patches": 4,
                        "num_global_patches": 64, "num_encoder_layers": 2},
        })
        cfg["data"] = {"dataset_name": "cifar10", "root": "/tmp/nonexistent-data",
                       "batch_size": 8,
                       "multicrop_config": {
                           "num_local_views": 2, "num_global_views": 2,
                           "global_size": [32, 32], "local_size": [8, 8],
                           "scale_threshold": 0.3,
                           "train_transforms": train_t(),
                           "test_transforms": test_t()}}
        cfg["linear_eval"] = {"epochs": 2, "input_dim": 16, "batch_size": 16,
                              "lr": 0.1}
    return cfg


# ----------------------------------------------------------------------
def sweep_config(algo: str, epochs: int, batch: int, overrides: dict) -> dict:
    """A row's config: `mini_config` at the row's batch, one KNN after the
    last epoch, DeepCluster's K-means at 50 iterations x 3 restarts and
    SeLA's 20 self-labelling iterations, then the row's overrides."""
    cfg = mini_config(algo, epochs=epochs, batch_size=batch)
    cfg["eval_every"] = epochs
    if algo == "deep_cluster":
        cfg["kmeans"] = {"n_iters": 50, "n_redo": 3}
    if algo == "sela":
        cfg["self_label_iters"] = 20
    cfg.update(overrides)
    return cfg


def run_row(name: str, algo: str, arch: str, batch: int, overrides: dict, epochs: int,
            sizes: tuple[int, int] = SIZES, device: str | None = None,
            run_root: str = os.path.join("outputs", "sweep")) -> dict:
    """One row: `epochs` epochs through the Trainer's epoch loop, the KNN
    after the last. Returns its row, with the batch it ran (DINO's is
    `mini_config`'s 8, whatever the row says, as in the JAX sweep), the
    photometric launches and the train steps of the run."""
    from ..train.trainer import Trainer

    t0 = time.time()
    cfg = sweep_config(algo, epochs, batch, overrides)
    d = os.path.join(run_root, name.replace("+", "_"))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cfg.yaml"), "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    tr = Trainer({"config": os.path.join(d, "cfg.yaml"), "algo": algo, "arch": arch,
                  "task": "train", "output": os.path.abspath(os.path.join(d, "run")),
                  "load": None}, synthetic_sizes=sizes, device=device)
    launches = tr.photometric_launches()
    state = tr.algorithm.pre_train(tr.state, tr)
    losses, ips = [], []
    for e in range(1, epochs + 1):
        state = tr.algorithm.pre_epoch(state, tr, e)
        idx_mat = tr.epoch_indices()
        te = time.time()
        state, metrics, _ = tr._run_epoch(state, idx_mat)
        state = tr.algorithm.post_epoch(state, e)
        losses.append(round(float(metrics["loss"].mean()), 4))
        ips.append(idx_mat.numel() / (time.time() - te))
    tr.state = state
    launches = tr.photometric_launches() - launches
    knn = tr.knn_validate()
    row = {"algo": name, "arch": arch, "batch": tr.pipeline.batch_size, "losses": losses,
           "knn": round(knn, 4), "img_per_sec": round(max(ips)),
           "wall_s": round(time.time() - t0), "steps": state.step,
           "photometric_launches": launches}
    print(f"[{name}] losses={losses} knn={knn:.4f} ips={max(ips):,.0f} "
          f"({time.time() - t0:.0f}s)", flush=True)
    return row


def run_sweep(rows, epochs: int, sizes=SIZES, device=None, arch=None, batch=None,
              run_root=os.path.join("outputs", "sweep")) -> list[dict]:
    """Each row of `rows` (`SWEEP`'s entries), an error row where it fails;
    `arch` and `batch` replace every row's where given."""
    results = []
    for name, algo, row_arch, bs, overrides in rows:
        try:
            results.append(run_row(name, algo, arch or row_arch, batch or bs, overrides,
                                   epochs, sizes, device, run_root))
        except Exception as e:  # record the failure, keep sweeping
            results.append({"algo": name, "error": f"{type(e).__name__}: {e}"})
            print(f"[{name}] FAILED {type(e).__name__}: {e}", flush=True)
    return results


def load_floors(path: str = FLOORS_PATH) -> dict:
    """{"card": ..., "floors": {row: img/s}, ...}, or empty floors."""
    if not os.path.exists(path):
        return {"floors": {}}
    with open(path) as f:
        return json.load(f)


def regressions(results: list[dict], floors: dict) -> list[str]:
    """The error rows, and the rows below FLOOR_RATIO of their floor."""
    out = []
    for r in results:
        if "error" in r:
            out.append(f"{r['algo']}: {r['error']}")
            continue
        floor = floors.get(r["algo"])
        if floor and r["img_per_sec"] < FLOOR_RATIO * floor:
            out.append(f"{r['algo']}: {r['img_per_sec']:,} img/s < "
                       f"{FLOOR_RATIO:.0%} of floor {floor:,}")
    return out


def write_floors(path: str, runs: list[dict], epochs: int) -> None:
    """Writes the slowest img/s of each row over `runs` (each {"card",
    "results"}) as the floors, with the cards they came from."""
    floors = {}
    for run in runs:
        for r in run["results"]:
            if "error" not in r:
                floors[r["algo"]] = min(floors.get(r["algo"], r["img_per_sec"]),
                                        r["img_per_sec"])
    cards = sorted({run["card"] for run in runs})
    with open(path, "w") as f:
        json.dump({"card": "; ".join(cards), "epochs": epochs, "runs": len(runs),
                   "ratio": FLOOR_RATIO, "floors": floors,
                   "note": f"each row's slowest best-epoch img/s over {len(runs)} run(s) of "
                           "python -m ssv_tpu_torch.tools.sweep"},
                  f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"WROTE {path}", flush=True)


def write_table(path: str, results: list[dict], card: str, epochs: int, sizes) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("# All-algorithm sweep of the port\n\n")
        f.write(f"{card}, synthetic CIFAR-shaped data ({sizes[0]:,} train / {sizes[1]:,} "
                f"test), {epochs} epochs each through the Trainer's epoch loop. KNN = "
                "20-NN label agreement on the test split. img/s = the best epoch's "
                "(host clock). `+fuse` rows set `fuse_views: true`; DINO on the ViT "
                "fuses by default.\n\n")
        f.write("| algorithm | arch | batch | per-epoch loss | KNN | img/s |\n")
        f.write("|---|---|---|---|---|---|\n")
        for r in results:
            if "error" in r:
                f.write(f"| {r['algo']} | — | — | ERROR: {r['error']} | — | — |\n")
            else:
                f.write(f"| {r['algo']} | {r['arch']} | {r['batch']} | "
                        f"{' → '.join(str(x) for x in r['losses'])} | "
                        f"{r['knn']} | {r['img_per_sec']:,} |\n")
        f.write(f"\nThroughput floors: `ssv_tpu_torch/tools/sweep_floors.json`; the sweep "
                f"fails if any row drops below {FLOOR_RATIO:.0%} of its floor.\n")
        f.write("\nGenerated by `python -m ssv_tpu_torch.tools.sweep`.\n")
    print("WROTE", path, flush=True)


def main(argv=None) -> int:
    """Runs the sweep; returns 1 on an error row or a row below its floor."""
    from .quality_run import hardware

    ap = argparse.ArgumentParser(prog="python -m ssv_tpu_torch.tools.sweep")
    ap.add_argument("epochs", nargs="?", type=int, default=3)
    ap.add_argument("--only", default=None, help="comma-separated row names")
    ap.add_argument("--no-write", action="store_true",
                    help="no table, no floors, no floor guard (smoke runs)")
    ap.add_argument("--update-floors", action="store_true",
                    help="write this run's img/s as the floors")
    ap.add_argument("--floors-from", nargs="+", default=None, metavar="RESULTS",
                    help="write the slowest of these --results files as the floors, "
                         "and run nothing")
    ap.add_argument("--floors", default=FLOORS_PATH, help="the floors file")
    ap.add_argument("--results", default=None,
                    help="also write {card, epochs, results} as JSON to this file")
    ap.add_argument("--table", default=TABLE_PATH)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n-train", type=int, default=SIZES[0])
    ap.add_argument("--n-test", type=int, default=SIZES[1])
    ap.add_argument("--arch", default=None, help="every row's backbone (tests)")
    ap.add_argument("--batch", type=int, default=0, help="every row's batch (tests)")
    args = ap.parse_args(argv)

    if args.floors_from:
        runs = []
        for path in args.floors_from:
            with open(path) as f:
                runs.append(json.load(f))
        write_floors(args.floors, runs, runs[0]["epochs"])
        return 0

    rows = SWEEP
    if args.only:
        names = set(args.only.split(","))
        rows = [s for s in SWEEP if s[0] in names]
    sizes = (args.n_train, args.n_test)
    card = hardware(args.device)
    results = run_sweep(rows, args.epochs, sizes, args.device, args.arch, args.batch or None,
                        run_root=os.path.join(os.path.dirname(args.table) or ".", "runs"))
    run = {"card": card, "epochs": args.epochs, "results": results}
    if args.results:
        with open(args.results, "w") as f:
            json.dump(run, f, indent=1)
    if args.no_write:
        print(json.dumps(results), flush=True)
        return 0

    floors = load_floors(args.floors)
    for r in results:
        floor = floors["floors"].get(r["algo"])
        if floor and "error" not in r:
            print(f"[{r['algo']}] {r['img_per_sec']:,} img/s = "
                  f"{r['img_per_sec'] / floor:.3f} of its floor {floor:,} "
                  f"({floors.get('card')})", flush=True)
    bad = regressions(results, floors["floors"])
    if args.update_floors:
        write_floors(args.floors, [run], args.epochs)
    write_table(args.table, results, card, args.epochs, sizes)
    print(json.dumps(results), flush=True)
    if bad and not args.update_floors:
        print("THROUGHPUT REGRESSIONS:\n  " + "\n  ".join(bad), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
