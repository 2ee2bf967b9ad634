"""Bytes and float operations of the photometric kernel (ColorJitter in a
per-image order, then the gray gate, on float32 NHWC images) and the least
time the card needs for one call.

Bytes: each input image read once and each output written once (float32),
the (B, 4) int32 order and the (B, 5) float32 params read once. Float
operations a pixel, as the kernel does them (add, multiply, divide,
min/max, floor): brightness 3 x (multiply, clip) = 9, contrast the gray
sum and 3 blends = 24, saturation gray and 3 blends = 23, the hue round
trip 34 (skipped where the shift is 0), the gate's gray 5 (where on)."""

from __future__ import annotations

OPS = {"brightness": 9, "contrast": 24, "saturation": 23, "hue": 34, "gate": 5}
KERNEL = "photometric_kernel"   # the kernel's name in a device trace contains this


def nbytes(batch: int, h: int, w: int) -> int:
    return 2 * batch * h * w * 3 * 4 + batch * 4 * 4 + batch * 5 * 4


def float_ops(batch: int, h: int, w: int, hue_rows: float, gate_rows: float) -> float:
    per_pixel = (batch * (OPS["brightness"] + OPS["contrast"] + OPS["saturation"])
                 + OPS["hue"] * hue_rows + OPS["gate"] * gate_rows)
    return per_pixel * h * w


def expected_rows(batch: int, view_cfg: dict) -> tuple[float, float]:
    """The rows of a batch that take the hue round trip and the gray gate,
    in expectation over the draws of the config's transform."""
    jitter = view_cfg["color_jitter"]
    hue_on = float(jitter.get("apply_prob", 1.0)) if float(jitter.get("hue", 0)) > 0 else 0.0
    return batch * hue_on, batch * float(view_cfg["random_gray"]["p"])


def least_seconds(n_bytes: float, ops: float, peaks: dict) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the float32 rate outside the
    tensor cores."""
    by_bytes, by_ops = n_bytes / peaks["hbm_bytes_per_s"], ops / peaks["fp32_flops"]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
