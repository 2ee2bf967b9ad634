"""Experiment initialization (reference common.py:96-129).

Fixed seed (420), config load, output dir under `outputs/<algo>/<arch>/`,
hyperparameter dump and logger, as ssv_tpu/core/experiment.py does; the
torch device the run uses is logged where the JAX package logs its platform.
"""

from __future__ import annotations

import os
import random
from datetime import datetime as dt

import numpy as np
import torch

from ..utils.logging import Logger
from .config import load_config

DEFAULT_SEED = 420  # parity with reference common.py:96-101


def seed_everything(seed: int = DEFAULT_SEED) -> int:
    """Seed host-side RNGs. Device-side randomness flows through explicit
    `torch.Generator`s seeded from this value."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed


def initialize_experiment(args: dict, output_root: str, device: torch.device,
                          seed: int = DEFAULT_SEED):
    """Returns (config, output_dir, logger)."""
    seed_everything(seed)
    config = load_config(args["config"])

    output_dir = os.path.join(output_root, args.get("output") or dt.now().strftime("%d-%m-%Y_%H-%M"))
    os.makedirs(output_dir, exist_ok=True)
    logger = Logger(output_dir)
    with open(os.path.join(output_dir, "hyperparameters.txt"), "w") as f:
        f.write(_render(config.raw()))

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    logger.print(f"Platform: {device.type} ({name}) | device: {device}",
                 mode="info")
    return config, output_dir, logger


def _render(d: dict, indent: int = 0) -> str:
    lines = []
    for k, v in d.items():
        if isinstance(v, dict):
            lines.append("  " * indent + f"{k}:")
            lines.append(_render(v, indent + 1))
        else:
            lines.append("  " * indent + f"{k}: {v}")
    return "\n".join(lines)
