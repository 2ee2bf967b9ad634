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


KINDS = ("conv", "linear", "table", "normal", "one", "zero")
BUFFER = "buffer"   # a spec's fourth entry: a state buffer, not a parameter
TABLE_STD = 0.02


def buffers(specs: list) -> set[str]:
    """The names that `specs` marks as state buffers of an extra module
    (`<key>.<buffer>`, e.g. `center.value`): drawn like any weight, put in
    the program's buffers, never trained or compared."""
    return {name for name, _, _, *mark in specs if mark == [BUFFER]}


def _normal_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def weights(specs: list, seed: int, device) -> dict[str, torch.Tensor]:
    """float32 weights by name from (name, shape, init[, "buffer"]) specs:
    `conv` normal with std sqrt(2 / fan_out), `linear` normal with std
    sqrt(1 / fan_in), `table` normal with std 0.02 truncated at 2 std (a
    ViT's CLS token and position tables; any rank), `normal` with std 1,
    `one`, `zero`. Three calls draw them, each only where a spec needs it,
    in this order: the `conv` and `linear` normals; the `table` uniforms,
    mapped through the inverse normal CDF; the `normal` normals."""
    specs = [tuple(s[:3]) for s in specs]
    unknown = {k for _, _, k in specs} - set(KINDS)
    if unknown:
        raise ValueError(f"unknown weight kinds {sorted(unknown)}; kinds: {KINDS}")
    g = _generator(streams(seed)["weights"], device)

    def draw(kinds, fn):
        n = sum(math.prod(s) for _, s, k in specs if k in kinds)
        return fn(n, generator=g, device=device) if n else None

    flat = draw(("conv", "linear"), torch.randn)
    tables = draw(("table",), torch.rand)
    normals = draw(("normal",), torch.randn)
    if tables is not None:
        lo, hi = _normal_cdf(-2.0), _normal_cdf(2.0)
        z = torch.erfinv(2.0 * (lo + tables * (hi - lo)) - 1.0) * math.sqrt(2.0)
        tables = torch.clamp(z, -2.0, 2.0) * TABLE_STD
    out, at = {}, {"flat": 0, "table": 0, "normal": 0}
    for name, shape, kind in specs:
        n = math.prod(shape)
        if kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind in ("table", "normal"):
            src = tables if kind == "table" else normals
            out[name] = src[at[kind]:at[kind] + n].reshape(shape)
            at[kind] += n
        else:
            fan = shape[0] * math.prod(shape[2:]) if kind == "conv" else shape[1]
            std = math.sqrt((2.0 if kind == "conv" else 1.0) / fan)
            out[name] = flat[at["flat"]:at["flat"] + n].reshape(shape) * std
            at["flat"] += n
    return out
