"""The benchmark of `ssv_tpu_torch` on NVIDIA H100 cards: `run.py` runs one
cell of the repository's BENCHMARK.json (see `harness.py`)."""
