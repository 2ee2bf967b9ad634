"""ssv_tpu_torch — the PyTorch / CUDA port of ssv_tpu for one NVIDIA H100.

It mirrors `ssv_tpu/`'s layout and names, imports torch, numpy and yaml,
and never JAX. Hand-written CUDA kernels live in `csrc/` and are built by
`ops/build.py` on first use; each has a plain PyTorch version beside it.
`csrc/` also holds the host C++ of the native IO layer (`data/native_io.py`),
built by g++ the same way.
"""

__version__ = "0.1.0"
