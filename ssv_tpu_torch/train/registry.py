"""Algorithm registry (port of ssv_tpu/train/registry.py)."""

from __future__ import annotations

from .algorithms.barlow import BarlowTwins
from .algorithms.byol import BYOL
from .algorithms.deep_cluster import DeepCluster
from .algorithms.dino import DINO
from .algorithms.moco import MoCo
from .algorithms.pirl import PIRL
from .algorithms.relic import ReLIC
from .algorithms.sela import SeLA
from .algorithms.simclr import SimCLR
from .algorithms.simsiam import SimSiam
from .algorithms.swav import SwAV

ALGORITHMS = {"simclr": SimCLR, "byol": BYOL, "simsiam": SimSiam, "relic": ReLIC,
              "barlow": BarlowTwins, "moco": MoCo, "swav": SwAV, "sela": SeLA,
              "dino": DINO, "pirl": PIRL, "deep_cluster": DeepCluster}


def build_algorithm(name: str, config, arch: str, data_info, device):
    if name not in ALGORITHMS:
        raise ValueError(f"Unknown algorithm {name!r}; expected one of {list(ALGORITHMS)}")
    return ALGORITHMS[name](config, arch, data_info, device)
