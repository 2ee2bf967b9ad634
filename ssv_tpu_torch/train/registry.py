"""Algorithm registry (port of ssv_tpu/train/registry.py)."""

from __future__ import annotations

from .algorithms.simclr import SimCLR

ALGORITHMS = {"simclr": SimCLR}

# algorithms of the JAX package that the port does not run yet
NOT_PORTED = ("moco", "byol", "dino", "pirl", "barlow", "simsiam", "relic",
              "deep_cluster", "swav", "sela")


def build_algorithm(name: str, config, arch: str, data_info, device):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not yet ported to ssv_tpu_torch (ROADMAP slice B)")
    if name not in ALGORITHMS:
        raise ValueError(f"Unknown algorithm {name!r}; expected one of {list(ALGORITHMS)}")
    return ALGORITHMS[name](config, arch, data_info, device)
