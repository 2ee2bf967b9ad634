"""What a run's inputs are, made from its `--seed` alone: the images and
labels, the weights, and the seed of the device draws (each epoch's order
of the images and the augmentation's draws). The same seed gives the same
inputs, and both sides of the comparison get them from here.

The seed is split into three independent 32-bit streams
(`numpy.random.SeedSequence`), so any whole number serves as a seed. The
images and the weights are drawn on the device by a `torch.Generator` in a
few large calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STREAMS = ("data", "weights", "draws")


def streams(seed: int) -> dict[str, int]:
    state = np.random.SeedSequence(int(seed)).generate_state(len(STREAMS))
    return {name: int(s) for name, s in zip(STREAMS, state)}


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def images(traffic: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """{train_images, train_labels, test_images, test_labels}: uint8 NHWC
    pixels and int32 labels, uniform."""
    g = _generator(streams(seed)["data"], device)
    shape = tuple(traffic["image"])
    out = {}
    for split in ("train", "test"):
        n = int(traffic[f"n_{split}"])
        out[f"{split}_images"] = torch.randint(0, 256, (n, *shape), generator=g, device=device,
                                               dtype=torch.uint8)
        out[f"{split}_labels"] = torch.randint(0, int(traffic["classes"]), (n,), generator=g,
                                               device=device, dtype=torch.int32)
    return out


def weights(specs: list, seed: int, device) -> dict[str, torch.Tensor]:
    """float32 weights by name from (name, shape, init) specs: `conv`
    normal with std sqrt(2 / fan_out), `linear` normal with std
    sqrt(1 / fan_in), `one`, `zero`. The normal draws are one call."""
    drawn = [(n, s, k) for n, s, k in specs if k in ("conv", "linear")]
    flat = torch.randn(sum(math.prod(s) for _, s, _ in drawn),
                       generator=_generator(streams(seed)["weights"], device), device=device)
    out, at = {}, 0
    for name, shape, kind in specs:
        if kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            fan = shape[0] * math.prod(shape[2:]) if kind == "conv" else shape[1]
            std = math.sqrt((2.0 if kind == "conv" else 1.0) / fan)
            out[name] = flat[at:at + n].reshape(shape) * std
            at += n
    return out

