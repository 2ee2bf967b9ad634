"""CLI entry point of the port, with the JAX package's flags:

    python -m ssv_tpu_torch.main -c <config> -m <arch> -a <algo> -t <task> [-o out] [-l ckpt] [-d cuda|cpu]

`-t train` runs. The inference tasks and resuming from `-l` need the
checkpoints of ROADMAP slice A, item 9, and exit with an error saying so.
`-d/--device` is the counterpart of the JAX package's `JAX_PLATFORMS`: the
run is on the CUDA card unless `--device cpu` asks for the CPU, and without
a card it stops with an error rather than fall back to the CPU.
"""

from __future__ import annotations

import argparse
import sys
from datetime import datetime as dt

TASKS = ["train", "linear_eval", "get_features"]
NETWORKS = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
            "resnext50", "resnext101", "wide_resnet50", "wide_resnet101", "vit"]
ALGORITHMS = ["simclr", "moco", "byol", "dino", "pirl", "barlow", "simsiam",
              "relic", "deep_cluster", "swav", "sela"]


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

    if args["task"] != "train":
        sys.exit(f"task {args['task']!r} is not yet ported to ssv_tpu_torch "
                 f"(ROADMAP slice A, item 9)")
    if args["load"] is not None:
        sys.exit("resuming from --load is not yet ported to ssv_tpu_torch "
                 "(ROADMAP slice A, item 9)")

    from .train.trainer import Trainer

    trainer = Trainer(args, device=args["device"])
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
