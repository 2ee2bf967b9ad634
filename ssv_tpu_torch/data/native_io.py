"""ctypes bindings for the port's native IO library, `csrc/ssv_io.cc`
(counterpart of ssv_tpu/data/native_io.py): the CIFAR binary reader, the
flat `.raw` cache and a threaded CHW -> HWC repack, with the JAX module's
signatures and results.

`ops/build.py` builds the library with g++ on first use, into
`build/ssv_tpu_torch/`. A failed build raises with the compiler's message:
unlike the JAX module, nothing falls back to NumPy. The NumPy versions
(`*_numpy`) stand beside the bindings as the tests' oracles.

The `.raw` layout: [magic u64 "SSV_RAW1"][n u64][h u32][w u32][c u32][pad
u32][labels n x i32][images n x h x w x c u8], native byte order.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ..ops import build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_MAGIC = 0x5353565F52415731   # "SSV_RAW1"
_HEADER = np.dtype([("magic", "u8"), ("n", "u8"), ("dims", "u4", 4)])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ssv_io")
    lib.chw_to_hwc_u8.argtypes = [_U8P, _U8P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int]
    lib.chw_to_hwc_u8.restype = None
    lib.read_cifar_binary.argtypes = [ctypes.c_char_p, ctypes.c_int, _U8P, _I32P,
                                      ctypes.c_int64]
    lib.read_cifar_binary.restype = ctypes.c_int64
    lib.write_raw_cache.argtypes = [ctypes.c_char_p, _U8P, _I32P, ctypes.c_int64,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.write_raw_cache.restype = ctypes.c_int
    lib.read_raw_cache_header.argtypes = [ctypes.c_char_p, _I32P]
    lib.read_raw_cache_header.restype = ctypes.c_int64
    lib.read_raw_cache.argtypes = [ctypes.c_char_p, _U8P, _I32P, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.read_raw_cache.restype = ctypes.c_int
    return lib


def available() -> bool:
    """Builds (if needed) and loads the library: True, or the build's
    error is raised."""
    return _lib() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _i32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def chw_to_hwc(images_chw: np.ndarray, n_threads: int = 4) -> np.ndarray:
    """(N, C, H, W) uint8 -> (N, H, W, C) uint8."""
    if images_chw.ndim != 4:
        raise ValueError(f"expected (N, C, H, W), got shape {images_chw.shape}")
    n, c, h, w = images_chw.shape
    src = np.ascontiguousarray(images_chw, dtype=np.uint8)
    dst = np.empty((n, h, w, c), np.uint8)
    _lib().chw_to_hwc_u8(_u8(src), _u8(dst), n, h, w, c, n_threads)
    return dst


def chw_to_hwc_numpy(images_chw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(images_chw.transpose(0, 2, 3, 1))


def read_cifar_binary(path: str, label_bytes: int, max_n: int):
    """One CIFAR binary batch file, rows of [label (1 or 2 bytes, the fine
    label last)][3072 bytes CHW], at most `max_n` rows (a partial row at
    the end is dropped): (images (n, 32, 32, 3) uint8, labels (n,) int32).
    Raises FileNotFoundError when the file cannot be opened."""
    if label_bytes not in (1, 2):
        raise ValueError(f"label_bytes must be 1 or 2, got {label_bytes}")
    images = np.empty((max_n, 32, 32, 3), np.uint8)
    labels = np.empty((max_n,), np.int32)
    n = _lib().read_cifar_binary(os.fsencode(path), label_bytes, _u8(images), _i32(labels),
                                 max_n)
    if n < 0:
        raise FileNotFoundError(path)
    return images[:n], labels[:n]


def read_cifar_binary_numpy(path: str, label_bytes: int, max_n: int):
    raw = np.fromfile(path, np.uint8)
    row = label_bytes + 3072
    n = min(len(raw) // row, max_n)
    raw = raw[: n * row].reshape(n, row)
    labels = raw[:, label_bytes - 1].astype(np.int32)
    images = raw[:, label_bytes:].reshape(n, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(images), labels


def _checked(images: np.ndarray, labels: np.ndarray):
    if images.ndim != 4 or labels.shape != images.shape[:1]:
        raise ValueError(f"images (N, H, W, C) and labels (N,), got {images.shape} and "
                         f"{labels.shape}")
    return np.ascontiguousarray(images, dtype=np.uint8), np.ascontiguousarray(labels,
                                                                              dtype=np.int32)


def write_raw_cache(path: str, images: np.ndarray, labels: np.ndarray) -> bool:
    """Writes (images (N, H, W, C) uint8, labels (N,)) as a `.raw` cache;
    True when every byte was written."""
    images, labels = _checked(images, labels)
    n, h, w, c = images.shape
    return _lib().write_raw_cache(os.fsencode(path), _u8(images), _i32(labels),
                                  n, h, w, c) == 0


def write_raw_cache_numpy(path: str, images: np.ndarray, labels: np.ndarray) -> bool:
    images, labels = _checked(images, labels)
    n, h, w, c = images.shape
    header = np.array([(_MAGIC, n, (h, w, c, 0))], _HEADER)
    with open(path, "wb") as f:
        for part in (header, labels, images):
            f.write(part.tobytes())
    return True


def read_raw_cache(path: str):
    """(images, labels) from a `.raw` cache, or None when the file is
    missing, is not a cache, or is shorter than its header says."""
    if not os.path.isfile(path):
        return None
    lib = _lib()
    hwc = np.zeros((3,), np.int32)
    n = lib.read_raw_cache_header(os.fsencode(path), _i32(hwc))
    if n < 0:
        return None
    h, w, c = (int(x) for x in hwc)
    images = np.empty((n, h, w, c), np.uint8)
    labels = np.empty((n,), np.int32)
    if lib.read_raw_cache(os.fsencode(path), _u8(images), _i32(labels), n, h, w, c) != 0:
        return None
    return images, labels


def read_raw_cache_numpy(path: str):
    if not os.path.isfile(path):
        return None
    raw = np.fromfile(path, np.uint8)
    if raw.size < _HEADER.itemsize:
        return None
    header = raw[:_HEADER.itemsize].view(_HEADER)[0]
    if header["magic"] != _MAGIC:
        return None
    n = int(header["n"])
    h, w, c = (int(x) for x in header["dims"][:3])
    start = _HEADER.itemsize + 4 * n
    if raw.size < start + n * h * w * c:
        return None
    labels = raw[_HEADER.itemsize:start].view(np.int32).copy()
    images = raw[start:start + n * h * w * c].reshape(n, h, w, c).copy()
    return images, labels
