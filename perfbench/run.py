"""Run one cell of BENCHMARK.json once on the card and print its result
line (the last line of standard output, one JSON object):

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

or `python -m perfbench.run ...` from the root of the checkout. Without a
CUDA card, or with fewer than the cell asks for, it exits 2 and prints no
result. It keeps every build and kernel cache inside the checkout, under
`build/`.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent


def process_age() -> float:
    """Seconds since this process started (Linux's /proc), or 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def prepare() -> None:
    """The checkout's root on the path in place of this file's folder; the
    caches in the checkout; no JAX behind a library's back."""
    sys.path[0] = str(ROOT)
    build = ROOT / "build" / "perfbench"
    # compiled bytecode of every module imported, torch's included, kept in
    # the checkout (written even where the environment turns writing off):
    # a later run loads it instead of compiling the sources again
    sys.pycache_prefix = str(build / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for key in ("WANDB_API_KEY", "WANDB_MODE"):
        os.environ.pop(key, None)


if __name__ == "__main__":
    t_start = T_START - process_age()
    prepare()
    from perfbench.harness import main

    sys.exit(main(t_start=t_start))
