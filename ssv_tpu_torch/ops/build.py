"""Build the package's native sources into shared libraries and load them.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`), and each
`csrc/<name>.cc` (host code: the CIFAR reader and `.raw` cache) by `g++`,
into a library with a plain C interface, loaded with `ctypes`. The build
happens on first use, into `build/ssv_tpu_torch/` at the root of the
checkout, under a file name keyed by a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is. A
failed build raises with the compiler's message: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ssv_tpu_torch"

# -fmad=false keeps every multiply and add rounded on its own, as the plain
# PyTorch versions round them; no fast-math, so division stays IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
# the host library's flags (the JAX package builds native/ssv_io.cc so)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels cannot be built")


def find_gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found on PATH; the native IO library cannot be built")


def source(name: str) -> Path:
    """csrc/<name>.cu or csrc/<name>.cc."""
    for suffix in (".cu", ".cc"):
        path = CSRC / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {name}.cu or {name}.cc under {CSRC}")


def _flags(src: Path) -> tuple[str, ...]:
    return NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS


def library_path(name: str) -> Path:
    src = source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (nvcc) or csrc/<name>.cc (g++) unless a
    library of the same hash exists. Raises RuntimeError with the
    compiler's stderr when the compile fails."""
    out = library_path(name)
    if out.is_file():
        return out
    src = source(name)
    compiler = find_nvcc() if src.suffix == ".cu" else find_gxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *_flags(src), "-o", tmp, str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed ({proc.returncode}) "
                               f"building {src.name}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu or .cc; one handle per
    process."""
    return ctypes.CDLL(str(build(name)))
