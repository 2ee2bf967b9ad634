"""Published peaks of the cards the benchmark knows, by the name
`torch.cuda.get_device_name()` gives (NVIDIA's data sheet, SXM part, dense
rates, at a 700 W power limit), and the card's line from nvidia-smi."""

from __future__ import annotations

import subprocess

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp32_flops": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"
