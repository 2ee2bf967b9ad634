"""CLI entry point of the port, with the JAX package's flags:

    python -m ssv_tpu_torch.main -c <config> -m <arch> -a <algo> -t <task> [-o out] [-l ckpt] [-d cuda|cpu]

`-t train` trains (through `Trainer.train_safe`, which saves `latest` on an
interrupt or error) and ends with the linear probe; with `-l <run dir>` it
resumes from that run's `latest` checkpoint. `-t linear_eval` and
`-t get_features` need `-l` and load its `best_model`: the first runs the
linear probe, the second writes `train_fvecs`, `train_gt`, `test_fvecs` and
`test_gt` as binary `.npy` files to the output directory.
`-d/--device` is the counterpart of the JAX package's `JAX_PLATFORMS`: the
run is on the CUDA card unless `--device cpu` asks for the CPU, and without
a card it stops with an error rather than fall back to the CPU.

Across ranks, under torchrun:

    torchrun --nproc_per_node N -m ssv_tpu_torch.main -c <config> -m <arch> -a <algo> -t train

starts the process group from torchrun's environment (NCCL, each rank on
`cuda:LOCAL_RANK`; gloo with `-d cpu`), trains data-parallel on the config's
global batch (`parallel/`), and destroys the group at the end. Without
torchrun's environment the run is the single-process one.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime as dt

import numpy as np

TASKS = ["train", "linear_eval", "get_features"]
NETWORKS = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
            "resnext50", "resnext101", "wide_resnet50", "wide_resnet101", "vit"]
ALGORITHMS = ["simclr", "moco", "byol", "dino", "pirl", "barlow", "simsiam",
              "relic", "deep_cluster", "swav", "sela"]


def _check_checkpoint_specified(args):
    if args["load"] is None:
        raise ValueError(
            "For inference tasks, model checkpoint must be specified using --load")


def main(argv=None):
    """Parses `argv` (default sys.argv) and runs the task; returns the Trainer."""
    ap = argparse.ArgumentParser(prog="python -m ssv_tpu_torch.main")
    ap.add_argument("-c", "--config", required=True, type=str,
                    help="Path to configuration file")
    ap.add_argument("-m", "--arch", required=True, type=str, choices=NETWORKS,
                    help="Encoder architecture to use")
    ap.add_argument("-a", "--algo", required=True, type=str, choices=ALGORITHMS,
                    help="Self-supervised algorithm to work with")
    ap.add_argument("-t", "--task", required=True, type=str, choices=TASKS,
                    help="Task to perform for chosen algorithm")
    ap.add_argument("-o", "--output", default=dt.now().strftime("%d-%m-%Y_%H-%M"),
                    type=str, help="Path to output directory")
    ap.add_argument("-l", "--load", default=None, type=str,
                    help="Path to directory containing trained checkpoints")
    ap.add_argument("-d", "--device", default="cuda", choices=["cuda", "cpu"],
                    help="Device to run on (default: cuda)")
    args = vars(ap.parse_args(argv))

    task = args["task"]
    if task != "train":
        _check_checkpoint_specified(args)

    from .parallel import mesh
    from .train.trainer import Trainer

    rank_device = mesh.init_from_env(args["device"])
    try:
        # one output directory for the run: rank 0's default name
        args["output"] = mesh.broadcast_object(args["output"])
        trainer = Trainer(args, device=rank_device or args["device"])
        if task == "train":
            trainer.train_safe()
        elif task == "linear_eval":
            trainer.perform_linear_eval()
        else:
            for split in ("train", "test"):
                fvecs, gt = trainer.build_features(split)
                if mesh.rank() == 0:
                    for name, arr in ((f"{split}_fvecs", fvecs), (f"{split}_gt", gt)):
                        np.save(os.path.join(trainer.output_dir, f"{name}.npy"),
                                arr.cpu().numpy())
    finally:
        if rank_device is not None:
            mesh.destroy()
    return trainer


if __name__ == "__main__":
    main()
